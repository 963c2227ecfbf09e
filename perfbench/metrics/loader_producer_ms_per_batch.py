"""loader_producer_ms_per_batch (data loader): the host ms the producer
thread of prefetch_to_device spends on a batch in the traced window, its
spans loader.assemble and loader.copy over the batches it copied."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    n = spans.count(("loader.copy",)) if spans is not None else 0
    return spans.host_ms(("loader.assemble", "loader.copy")) / n if n else None
