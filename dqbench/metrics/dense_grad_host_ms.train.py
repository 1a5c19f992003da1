"""Host ms a step inside the program's ``grad_shift.dense`` span (the dense
layer's forward pass and its autograd backward), from a stretch with the
program's recorder installed and no profiler."""
import program_trace


def read(ctx):
    return program_trace.host_ms(ctx, "grad_shift.dense")
