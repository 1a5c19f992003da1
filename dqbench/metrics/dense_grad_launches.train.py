"""Device operations (kernels, copies, sets) a step launched inside the
program's ``grad_shift.dense`` span, on any thread, from the profiled
stretch with the program's recorder installed."""
import program_trace


def read(ctx):
    r = program_trace.of(ctx)
    ops = 0 if r is None else r.trace.under("grad_shift.dense")[1]
    return ops / r.trace.steps if ops else None
