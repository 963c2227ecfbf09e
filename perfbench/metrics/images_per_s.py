"""images_per_s (end to end): every image completed in the window over the
window's seconds (host clock; the window ends when its last call does)."""


def read(ctx):
    return ctx.images / ctx.window_s if ctx.window_s > 0 else None
