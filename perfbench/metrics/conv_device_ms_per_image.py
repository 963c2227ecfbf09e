"""conv_device_ms_per_image (convolutions, cuDNN): device ms of the
convolution groups (perfbench/bench/groups.py, forward and backward) in the
traced window, over its images."""

from perfbench.bench.groups import CONVOLUTION


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.images:
        return None
    ms = t.group_seconds(CONVOLUTION) * 1e3
    return ms / ctx.images if ms > 0 else None
