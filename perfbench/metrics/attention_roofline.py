"""attention_roofline (the linear-attention kernels): the least time of the
traced window's linear attentions (perfbench/cost/unet.py, counted from
the shapes) over the device time of the forward kernels, in %."""

from perfbench.bench import peaks

KERNELS = ("fla_fused_kernel", "fla_ctx_pass_kernel", "fla_out_pass_kernel")


def read(ctx):
    t = ctx.trace
    work = ctx.work.get("attention")
    if t is None or work is None:
        return None
    device_s = t.seconds_of(KERNELS)
    if device_s <= 0:
        return None
    least, _ = peaks.least_seconds(work[0] * ctx.calls, work[1] * ctx.calls)
    return 100.0 * least / device_s
