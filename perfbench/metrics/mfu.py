"""mfu (the whole step): the model operations of the traced window's calls
(perfbench/cost, per the cell's entry) over the window's seconds times the
H100's published fp32 peak (67 TFLOP/s; the configurations run fp32 with
TF32 off), in %."""

from perfbench.bench import peaks


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or not ctx.calls:
        return None
    return 100.0 * ctx.work["flops"] * ctx.calls / (t.window_s * peaks.FP32_FLOPS)
