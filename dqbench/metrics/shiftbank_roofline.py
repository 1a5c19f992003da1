"""Share of its roofline of ``shiftbank_kernel`` in the traced stretch:
the summed bound of the steps' bank launches (a worker's share of a class's
bank each, operations or bytes at the chip's peak, from the configuration
alone) over the summed device time of the kernel's launches."""

KERNEL = "shiftbank_kernel"


def read(ctx):
    t = ctx.trace
    ops = [] if t is None else t.ops_named(KERNEL)
    if not ops:
        return None
    samples = ctx.cell.traffic["batch"] * ctx.model.n_patches
    bound = t.steps * ctx.counters.bank_bound_s(ctx.model, samples, ctx.cell.params["workers"])
    return 100.0 * bound / sum(o.dur for o in ops)
