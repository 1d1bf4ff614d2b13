"""Operations the window's MD steps need (model forward and force backward;
``portbench/costs/model.py`` at the live rows of the window's last step)
over the window's time at the published float32 peak of 67 TFLOP/s, in
percent."""

from portbench.costs import model as cm
from portbench.costs import peaks


def read(ctx):
    if ctx.get('kind') != 'md' or ctx['device'].type != 'cuda':
        return None
    ops = cm.force_call_flops(ctx['specs'], ctx['degrees'], ctx['deg_cap'],
                              ctx['chunk_rows'], ctx['geom'])['total']
    return 100.0 * ops * ctx['steps'] / (ctx['window_s'] * peaks.FP32_FLOPS)
