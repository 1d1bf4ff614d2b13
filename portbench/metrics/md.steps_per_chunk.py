"""Mean steps of the chunks the MD engine accepted in the window (its
``run`` rows): the rebuild cadence the window ran at."""


def read(ctx):
    steps = ctx.get('chunk_steps') if ctx.get('kind') == 'md' else None
    if not steps:
        return None
    return sum(steps) / len(steps)
