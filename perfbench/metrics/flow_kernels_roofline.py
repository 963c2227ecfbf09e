"""flow_kernels_roofline (the flow kernels): the least time of the traced
window's mix-and-tail work (perfbench/cost/glow.py, counted from the
shapes) over the device time of the kernels that ran it (names holding
channel_mix_ or coupling_tail), in %."""

from perfbench.bench import peaks

KERNELS = ("channel_mix_", "coupling_tail")


def read(ctx):
    t = ctx.trace
    work = ctx.work.get("flow")
    if t is None or work is None:
        return None
    device_s = t.seconds_of(KERNELS)
    if device_s <= 0:
        return None
    least, _ = peaks.least_seconds(work[0] * ctx.calls, work[1] * ctx.calls)
    return 100.0 * least / device_s
