"""Process start to the first timed step: imports, data, weights, the
kernels' build where the checkout has none yet, and the first steps."""


def read(ctx):
    return ctx.setup_s
