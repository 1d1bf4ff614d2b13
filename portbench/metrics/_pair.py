"""Shared arithmetic of the conv pairs' roofline readers: the least time
the window's launches of one pair could take, from the frozen counts at
the live rows of the window's last step, over the pair's device time in
the trace."""

import re

from portbench.costs import conv as cc
from portbench.costs import model as cm
from portbench.costs import peaks


def share(ctx, geom: bool, counter: str, fwd: str, bwd: str):
    if ctx.get('kind') != 'md' or ctx['geom'] != geom:
        return None
    pat = re.compile(f'(?:{fwd})|(?:{bwd})')
    dev_s = sum(s for name, s in ctx['trace']['kernel_s'].items()
                if pat.search(name))
    launches = ctx['launches'].get(counter, 0)
    if dev_s <= 0 or launches <= 0:
        return None
    shapes = cm.conv_shapes(ctx['specs'], ctx['deg_cap'])
    chunks = cc.chunk_live(ctx['degrees'], ctx['deg_cap'], ctx['chunk_rows'])
    bound = 0.0
    for shape in shapes:
        for rows, live in chunks:
            f = cc.conv_cost(shape, rows, live, geom=geom)
            b = cc.conv_bytes(shape, rows, live, geom=geom)
            for i in (0, 1):
                bound += cc.roofline_s(f[i], b[i], peaks.FP32_FLOPS,
                                       peaks.HBM_BYTES)[0]
    calls = launches / (len(shapes) * len(chunks))
    return 100.0 * bound * calls / dev_s
