"""Operations the window's training steps need over the window's time at
the published float32 peak of 67 TFLOP/s, in percent. A step needs the
forward and the force backward of its structures (``portbench/costs``,
at the dataset's mean edges inside the cutoff) and the backward of both
to the parameters, counted as twice the pass it differentiates."""

from portbench.costs import model as cm
from portbench.costs import peaks


def read(ctx):
    if ctx.get('kind') != 'train' or ctx['device'].type != 'cuda':
        return None
    per = cm.train_structure_flops(ctx['specs'], ctx['atoms_per_structure'],
                                   ctx['edges_per_structure'])
    ops = per * ctx['batch_size'] * ctx['steps']
    return 100.0 * ops / (ctx['window_s'] * peaks.FP32_FLOPS)
