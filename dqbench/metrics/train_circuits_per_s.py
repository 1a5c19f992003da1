"""Parameter-shift circuits of every step completed in the window,
C x B x Np x (2P + 1) a step, over the whole window (host clock)."""


def read(ctx):
    batch = ctx.cell.traffic["batch"]
    return ctx.steps * ctx.counters.circuits_per_step(ctx.model, batch) / ctx.window_s
