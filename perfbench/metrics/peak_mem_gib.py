"""peak_mem_gib (end to end): torch.cuda.max_memory_allocated at the
window's end, after a reset at the run's start, in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
