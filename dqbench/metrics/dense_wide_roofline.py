"""Share of its roofline of the dense gradient's wide route in the traced
stretch: the least time of a step's call (``dense_wide_counters``: an inner
product a (class, patch), psi's gates once a class, at the chip's peak) times
the traced steps, over the summed device time of the route's kernels
(``dense_wide_psi_kernel`` and ``dense_wide_kernel``)."""
import dense_wide_counters

KERNEL = "dense_wide"


def read(ctx):
    t = ctx.trace
    ops = [] if t is None else t.ops_named(KERNEL)
    if not ops:
        return None
    samples = ctx.cell.traffic["batch"] * ctx.model.n_patches
    bound = t.steps * dense_wide_counters.bound_s(ctx.model, samples)
    return 100.0 * bound / sum(o.dur for o in ops)
