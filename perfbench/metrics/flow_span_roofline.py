"""flow_span_roofline (flow kernels): the least time of the work inside the
spans flow.mix and flow.tail (and, in a backward pass, flow.mix.bwd and
flow.tail.bwd) over the device time put down to those spans, in %. The
work is the mix-and-tail work of perfbench/cost/glow.py, and in a backward
pass the mix's weight and bias gradients (perfbench/cost/flow_spans.py),
counted from the shapes; whatever implements the mix and the tail, the
spans hold the same work."""

from perfbench.bench import peaks
from perfbench.cost.flow_spans import mix_weight_grad_work

SPANS = ("flow.mix", "flow.tail", "flow.mix.bwd", "flow.tail.bwd")


def read(ctx):
    spans = getattr(ctx, "spans", None)
    work = ctx.work.get("flow")
    if spans is None or work is None:
        return None
    device_s = spans.device_seconds(SPANS)
    if device_s <= 0:
        return None
    nbytes, ops = work
    if spans.count(("flow.mix.bwd",)):
        extra = mix_weight_grad_work(ctx.spec.config, ctx.spec.traffic["batch"])
        nbytes, ops = nbytes + extra[0], ops + extra[1]
    least, _ = peaks.least_seconds(nbytes * ctx.calls, ops * ctx.calls)
    return 100.0 * least / device_s
