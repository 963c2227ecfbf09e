"""attention_span_roofline (linear-attention kernels): the least time of
the traced window's linear attentions (perfbench/cost/unet.py, counted from
the shapes) over the device time put down to the span
unet.linear_attention, in %."""

from perfbench.bench import peaks


def read(ctx):
    spans = getattr(ctx, "spans", None)
    work = ctx.work.get("attention")
    if spans is None or work is None:
        return None
    device_s = spans.device_seconds(("unet.linear_attention",))
    if device_s <= 0:
        return None
    least, _ = peaks.least_seconds(work[0] * ctx.calls, work[1] * ctx.calls)
    return 100.0 * least / device_s
