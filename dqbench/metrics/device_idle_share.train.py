"""Share of an untraced step in which no operation runs on the device: one
less the device's busy time a traced step over the measured window's mean
step.  The profiler slows the host's launches and so stretches a traced
step, not the device's work in it; the traced stretch's own idle share is
``device.busy_s`` against ``device.window_s``."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.steps or not ctx.steps or t.busy_s <= 0:
        return None
    busy_per_step = t.busy_s / t.steps
    mean_step = ctx.window_s / ctx.steps
    return 100.0 * (1.0 - busy_per_step / mean_step)
