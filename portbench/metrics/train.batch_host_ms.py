"""Host milliseconds a training step spends fetching its batch from the
program's loader and copying it to the device (the harness's feed, timed
around ``next(loader)`` and ``Trainer.batch_to_device``)."""


def read(ctx):
    if ctx.get('kind') != 'train' or not ctx.get('steps'):
        return None
    return 1e3 * ctx['host_s'] / ctx['steps']
