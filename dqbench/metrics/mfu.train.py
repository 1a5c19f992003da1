"""The whole step's share of the chip's float32 peak: the operations a
step needs (every worker's share of every class's bank, and the dense
layer's gradient as three forward evaluations), times the steps of the
measured window, over the window times 67 TFLOP/s."""


def read(ctx):
    if not ctx.steps:
        return None
    c = ctx.counters
    flops = c.step_flops(ctx.model, ctx.cell.traffic["batch"], ctx.cell.params["workers"])
    return 100.0 * flops * ctx.steps / (ctx.window_s * c.PEAK_F32_FLOPS)
