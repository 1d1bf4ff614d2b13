"""Share of the traced training window in which no operation ran on the
device: 1 - (union of the device's operation intervals) / window, in
percent."""


def read(ctx):
    t = ctx.get('trace')
    if ctx.get('kind') != 'train' or not t or t['busy_s'] <= 0:
        return None
    return 100.0 * (1.0 - t['busy_s'] / t['window_s'])
