"""setup_s (end to end): seconds from the process's start to the first
timed call: imports, the kernels' build (a checkout's first run) or load,
the inputs, the warm-up."""


def read(ctx):
    return ctx.setup_s
