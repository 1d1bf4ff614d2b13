"""Training orchestrator (reference sevenn/scripts/train.py:38-90,
train_v2): datasets -> loaders -> model -> trainer -> epoch loop.

Counterpart of ``sevennet_exp_tpu/scripts/train.py`` on one device,
without the multi-process bootstrap and the data-parallel mesh (ROADMAP
A.7) and without continuing from a checkpoint (ROADMAP A.5's
``processing_continue``). The model trains on the card unless the caller
or the config says ``device: cpu``.
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
from ..train.trainer import Trainer
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
    log.init_file(os.path.join(working_dir, 'log.sevenn'))
    log.greeting()
    log.dict_write(
        {k: v for k, v in config.items() if not k.startswith('_')},
        'Configuration:',
    )
    if config.get(KEY.CONTINUE, {}).get(KEY.CHECKPOINT):
        raise NotImplementedError(
            'continuing from a checkpoint is not in the port yet '
            '(processing_continue, ROADMAP A.5)')
    device = torch.device(device or config.get('device', 'cuda'))

    log.timer_start('dataset')
    datasets = datasets_from_config(config, working_dir)
    log.timer_end('dataset', 'Dataset build')
    loaders = {name: loader_from_config(config, ds,
                                        is_train=(name == 'trainset'))
               for name, ds in datasets.items()}

    model = build_e3_equivariant_model(config)
    params, mask = model.init(
        torch.Generator().manual_seed(config.get(KEY.RANDOM_SEED, 1)))
    log.print_model_info(model, params, mask)
    log.format_k_v('device', str(device), write=True)

    trainer = Trainer.from_config(model, params, mask, config, device=device)
    log.timer_start('train')
    processing_epoch_v2(trainer, config, loaders, working_dir)
    log.timer_end('train', 'Total training')
    return trainer
