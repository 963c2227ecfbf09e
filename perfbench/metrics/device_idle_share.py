"""device_idle_share (device): 1 - the union of the device's kernels,
copies and fills over the traced window, as a fraction."""


def read(ctx):
    t = ctx.trace
    return None if t is None or t.window_s <= 0 else 1.0 - t.busy_s / t.window_s
