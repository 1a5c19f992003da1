"""Host ms a step inside the program's calls into the executor (the data
plane), from the harness's wrapper around it, over the measured window."""


def read(ctx):
    if not ctx.steps:
        return None
    return ctx.executor_s / ctx.steps * 1e3
