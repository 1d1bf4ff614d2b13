"""The geometry-fused conv pair (``fused_conv_geom_fwd_kernel<1>`` and
``fused_conv_geom_bwd_kernel<NSH, 1>``, the chunked large-system path):
its least time by the frozen ``conv_cost`` / ``conv_bytes`` at 67 TFLOP/s
and 3.35 TB/s, over its device time in the traced window, in percent."""

from portbench.metrics._pair import share


def read(ctx):
    return share(ctx, True, 'fused_conv_geom_fwd',
                 r'fused_conv_geom_fwd_kernel<1>',
                 r'fused_conv_geom_bwd_kernel<\d+, ?1>')
