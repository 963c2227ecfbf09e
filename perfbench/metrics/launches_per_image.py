"""launches_per_image (kernel dispatch on the host): the device kernels the
traced window ran, over its images."""


def read(ctx):
    t = ctx.trace
    return None if t is None or not ctx.images else t.launches / ctx.images
