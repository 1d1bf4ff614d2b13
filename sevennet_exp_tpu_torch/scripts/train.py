"""Training orchestrator (reference sevenn/scripts/train.py:38-90,
train_v2): datasets -> loaders -> model -> trainer -> epoch loop.

Counterpart of ``sevennet_exp_tpu/scripts/train.py``. Under a
multi-process launch (torchrun, mpirun, srun: ``parallel/distributed.py``)
the processes join one ``torch.distributed`` group first; with ``IS_DDP``
(``sevenn -d``) each iterates its stripe of the train batches and the
trainer averages the gradients over the group. Only rank 0 writes the
log, ``lc.csv`` and the checkpoints. With ``continue: {checkpoint: ...}``
(a native checkpoint, a reference ``.pth`` or a pretrained keyword) the
model, its parameters and the first epoch come from
``processing_continue_v2``; the trainable mask comes from ``model.init``
on the config's seed and the optimizer starts fresh, as in the JAX
package. The model trains on the card unless the caller or the config
says ``device: cpu``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from .. import _keys as KEY
from ..data.dataset import datasets_from_config
from ..data.loader import GraphLoader
from ..logger import Logger
from ..model.build import build_e3_equivariant_model
from ..parallel.distributed import maybe_initialize, world
from ..train.trainer import Trainer
from .processing_continue import processing_continue_v2
from .processing_epoch import processing_epoch_v2


def loader_from_config(config, dataset, is_train: bool = False,
                       **caps) -> GraphLoader:
    return GraphLoader(
        dataset.graphs if hasattr(dataset, 'graphs') else dataset,
        batch_size=config.get(KEY.BATCH_SIZE, 6),
        shuffle=is_train and config.get(KEY.TRAIN_SHUFFLE, True),
        seed=config.get(KEY.RANDOM_SEED, 1),
        **caps,
    )


def train_v2(config: Dict[str, Any], working_dir: str = '.',
             device: Optional[str] = None) -> Trainer:
    log = Logger()
    device = torch.device(device or config.get('device', 'cuda'))
    # the multi-process bootstrap (a no-op in one process), then the
    # group's rank: only rank 0 logs and writes files
    maybe_initialize(device=device)
    rank, size = world()
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    log.rank = rank
    log.init_file(os.path.join(working_dir, 'log.sevenn'))
    log.greeting()
    log.dict_write(
        {k: v for k, v in config.items() if not k.startswith('_')},
        'Configuration:',
    )
    if size > 1 or torch.distributed.is_initialized():
        log.format_k_v('distributed', f'process {rank} of {size}, backend '
                       f'{torch.distributed.get_backend()}', write=True)

    start_epoch, cont_state, model = 1, None, None
    if config.get(KEY.CONTINUE, {}).get(KEY.CHECKPOINT):
        model, cont_state = processing_continue_v2(config)
        start_epoch = cont_state['start_epoch']

    log.timer_start('dataset')
    datasets = datasets_from_config(config, working_dir)
    log.timer_end('dataset', 'Dataset build')
    # data parallel: the train batches striped over the group; the other
    # sets run whole on every process (no reduction needed)
    shard = ((rank, size) if config.get(KEY.IS_DDP)
             and torch.distributed.is_initialized() else None)
    loaders = {name: loader_from_config(
                   config, ds, is_train=(name == 'trainset'),
                   **({'shard': shard} if shard and name == 'trainset'
                      else {}))
               for name, ds in datasets.items()}

    seed = torch.Generator().manual_seed(config.get(KEY.RANDOM_SEED, 1))
    if model is None:
        model = build_e3_equivariant_model(config)
        params, mask = model.init(seed)
    else:
        # continued: the model was rebuilt from the checkpoint's config
        params = cont_state['params']
        _, mask = model.init(seed)
    log.print_model_info(model, params, mask)
    log.format_k_v('device', str(device), write=True)

    trainer = Trainer.from_config(model, params, mask, config, device=device)
    log.timer_start('train')
    processing_epoch_v2(trainer, config, loaders, working_dir,
                        start_epoch=start_epoch)
    log.timer_end('train', 'Total training')
    return trainer
