"""The 95th percentile of the wall time of every step of the window, each
ending when its loss is read back (host clock; linear interpolation
between order statistics)."""
import statistics


def read(ctx):
    if len(ctx.step_s) < 2:
        return ctx.step_s[0] * 1e3 if ctx.step_s else None
    return statistics.quantiles(ctx.step_s, n=20, method="inclusive")[18] * 1e3
