"""call_p95_ms (end to end): the 95th percentile (linear interpolation) of
every call's milliseconds in the window, each timed by CUDA events recorded
on the stream before and after the call and read after the window, so the
host never waits on the card where the path itself does not."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx.call_ms, 95)) if ctx.call_ms else None
