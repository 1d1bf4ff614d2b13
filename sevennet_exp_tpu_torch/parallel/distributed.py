"""Multi-process bootstrap for data-parallel training.

Counterpart of ``sevennet_exp_tpu/parallel/distributed.py``, with the
reference's own launcher handling (sevenn/main/sevenn.py:59-76:
torchrun's WORLD_SIZE / LOCAL_RANK or OpenMPI's OMPI_COMM_WORLD_* ->
``dist.init_process_group``). One process per device: when a recognised
launcher started more than one process, ``maybe_initialize`` joins them
into one ``torch.distributed`` group (NCCL for a CUDA device, gloo for
the CPU; never one in place of the other) and binds ``cuda:LOCAL_RANK``.
A single process is a no-op, so every entry point can call it.

Launch environments recognised:
  - torchrun (WORLD_SIZE > 1, RANK, LOCAL_RANK, MASTER_ADDR / MASTER_PORT)
  - OpenMPI mpirun (OMPI_COMM_WORLD_SIZE > 1, OMPI_COMM_WORLD_RANK,
    OMPI_COMM_WORLD_LOCAL_RANK; MASTER_ADDR / MASTER_PORT given by the user)
  - SLURM srun (SLURM_NTASKS > 1, SLURM_PROCID, SLURM_LOCALID; MASTER_ADDR /
    MASTER_PORT given by the user)

The JAX package's TPU pod and multi-slice environments are TPU machinery
and have no counterpart here.

Data contract (``IS_DDP``): every process loads the whole dataset and
iterates its stripe of the train batches (``GraphLoader(shard=(rank,
world))``); the trainer averages the gradients over the group
(``train/trainer.py``).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch


class LaunchEnv(NamedTuple):
    name: str            # 'torchrun' | 'ompi' | 'slurm'
    world_size: int
    rank: int
    local_rank: int


def _int(value: Optional[str], default: int) -> int:
    try:
        return int(value) if value is not None else default
    except ValueError:
        return default


def detect_launch_env() -> Optional[LaunchEnv]:
    """The recognised multi-process launch environment, or None for a
    plain single-process run."""
    size = _int(os.environ.get('WORLD_SIZE'), 1)
    if size > 1:
        return LaunchEnv('torchrun', size,
                         _int(os.environ.get('RANK'), 0),
                         _int(os.environ.get('LOCAL_RANK'), 0))
    size = _int(os.environ.get('OMPI_COMM_WORLD_SIZE'), 1)
    if size > 1:
        return LaunchEnv('ompi', size,
                         _int(os.environ.get('OMPI_COMM_WORLD_RANK'), 0),
                         _int(os.environ.get('OMPI_COMM_WORLD_LOCAL_RANK'),
                              0))
    size = _int(os.environ.get('SLURM_NTASKS'), 1)
    if size > 1:
        return LaunchEnv('slurm', size,
                         _int(os.environ.get('SLURM_PROCID'), 0),
                         _int(os.environ.get('SLURM_LOCALID'), 0))
    return None


def world() -> tuple:
    """(rank, world size) of the initialised group, else (0, 1)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return (torch.distributed.get_rank(),
                torch.distributed.get_world_size())
    return 0, 1


def maybe_initialize(device=None) -> bool:
    """Join the processes of a recognised launch into one group when none
    is initialised yet; True when the group has more than one process.

    device: the device this process trains on ('cuda' or 'cpu'); a CUDA
    device takes NCCL and is bound to ``cuda:LOCAL_RANK``, the CPU takes
    gloo."""
    env = detect_launch_env()
    if env is None:
        return world()[1] > 1
    if not torch.distributed.is_initialized():
        addr = os.environ.get('MASTER_ADDR')
        port = os.environ.get('MASTER_PORT')
        if not (addr and port):
            raise RuntimeError(f'{env.name} launch of {env.world_size} '
                               'processes: set MASTER_ADDR and MASTER_PORT')
        cuda = torch.device(device or 'cuda').type == 'cuda'
        if cuda:
            torch.cuda.set_device(env.local_rank)
        torch.distributed.init_process_group(
            backend='nccl' if cuda else 'gloo',
            init_method=f'tcp://{addr}:{port}',
            world_size=env.world_size, rank=env.rank)
    return world()[1] > 1
