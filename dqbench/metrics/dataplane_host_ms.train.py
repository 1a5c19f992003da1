"""Host ms a step inside the program's ``dataplane.run`` spans (the data
plane's calls: each worker's kernel call and the gather), from a stretch
with the program's recorder installed and no profiler."""
import program_trace


def read(ctx):
    return program_trace.host_ms(ctx, "dataplane.run")
