"""optimizer_span_device_ms_per_step (trainer and optimizer): the device ms
put down to the span optim.apply (the clips and Adam) per train step of the
traced window."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    steps = ctx.work.get("steps", 0) * ctx.calls
    if spans is None or not steps:
        return None
    ms = spans.device_seconds(("optim.apply",)) * 1e3
    return ms / steps if ms > 0 else None
