"""Device ms a step of the operations the step's thread launched outside
its calls into the executor (bank build, gradient assembly, the dense
layer's gradient, the update), from the traced stretch."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.ops:
        return None
    ms = sum(o.dur for o in t.ops if o.span and o.span not in ("executor", "outside"))
    return ms / t.steps * 1e3
