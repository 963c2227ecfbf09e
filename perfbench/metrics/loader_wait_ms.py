"""loader_wait_ms (data loader): the mean host ms a train step of the
traced window waited on prefetch_to_device's iterator (host clock around
the harness's next())."""


def read(ctx):
    waits = ctx.work.get("loader_waits")
    return 1e3 * sum(waits) / len(waits) if waits else None
