"""Device ms a step of the operations (kernels, copies, sets) launched
inside the program's ``grad_shift.dense`` span, on any thread, from the
profiled stretch with the program's recorder installed."""
import program_trace


def read(ctx):
    r = program_trace.of(ctx)
    secs, ops = (0.0, 0) if r is None else r.trace.under("grad_shift.dense")
    return secs / r.trace.steps * 1e3 if ops else None
