"""Epoch loop: lc.csv learning curve, best/periodic checkpoints
(reference sevenn/scripts/processing_epoch.py:13-98).

Copy of ``sevennet_exp_tpu/scripts/processing_epoch.py`` on the port's
trainer: the same columns of ``lc.csv``, the same checkpoint names
(``checkpoint_0``, ``_best``, ``_<epoch>``, ``_last``), in the JAX
package's native format.
"""

from __future__ import annotations

import os
from typing import Dict

from .. import _keys as KEY
from ..checkpoint import save_checkpoint
from ..logger import Logger
from ..train.error_recorder import ErrorRecorder


def processing_epoch_v2(
    trainer,
    config: Dict,
    loaders: Dict[str, object],
    working_dir: str = '.',
    start_epoch: int = 1,
):
    log = Logger()
    total_epoch = config.get(KEY.EPOCH, 100)
    per_epoch = config.get(KEY.PER_EPOCH, 10)
    best_metric_name = config.get(KEY.BEST_METRIC, 'TotalLoss')
    train_loader = loaders['trainset']
    valid_loader = loaders.get('validset')

    lc_path = os.path.join(working_dir, 'lc.csv')
    recorders = {
        name: ErrorRecorder.from_config(config) for name in loaders
    }
    metric_names = [m.name for m in recorders['trainset'].metrics]
    with open(lc_path, 'w') as f:
        cols = ['epoch', 'lr'] + [
            f'{split}_{m}' for split in recorders for m in metric_names
        ]
        f.write(','.join(cols) + '\n')

    def write_cp(tag):
        params, aux = trainer.get_checkpoint_pieces()
        save_checkpoint(
            os.path.join(working_dir, f'checkpoint_{tag}.pth.sevennet'),
            config, params,
            optimizer_state=aux, epoch=epoch,
        )

    epoch = start_epoch - 1
    write_cp('0')
    best = float('inf')
    for epoch in range(start_epoch, total_epoch + 1):
        log.timer_start('epoch')
        trainer.run_one_epoch(
            train_loader, is_train=True,
            error_recorder=recorders['trainset'],
        )
        vals = {'trainset': recorders['trainset'].epoch_forward()}
        for name, loader in loaders.items():
            if name == 'trainset':
                continue
            trainer.run_one_epoch(
                loader, is_train=False, error_recorder=recorders[name]
            )
            vals[name] = recorders[name].epoch_forward()

        # scheduler (ReduceLROnPlateau consumes the validation metric)
        metric_src = vals.get('validset', vals['trainset'])
        trainer.scheduler_step(metric_src.get(best_metric_name))

        with open(lc_path, 'a') as f:
            row = [str(epoch), f'{trainer.get_lr():.8g}']
            for split in recorders:
                for m in metric_names:
                    row.append(f'{vals.get(split, {}).get(m, float("nan")):.8f}')
            f.write(','.join(row) + '\n')

        log.epoch_write(
            epoch, trainer.get_lr(), vals['trainset'], vals.get('validset')
        )
        log.timer_end('epoch', f'Epoch {epoch} elapsed')

        crit = metric_src.get(best_metric_name, float('inf'))
        if crit != crit:  # NaN (e.g. empty valid split) -> no comparison
            crit = float('inf')
        if crit <= best:
            best = crit
            write_cp('best')
        if per_epoch and epoch % per_epoch == 0:
            write_cp(str(epoch))
    write_cp('last')
