"""optimizer_device_ms_per_step (trainer and optimizer): device ms of the
foreach group (the clips and Adam, perfbench/bench/groups.py) per train
step of the traced window."""


def read(ctx):
    t = ctx.trace
    steps = ctx.work.get("steps", 0) * ctx.calls
    if t is None or not steps:
        return None
    ms = t.group_seconds(("optimizer and clips (foreach)",)) * 1e3
    return ms / steps if ms > 0 else None
