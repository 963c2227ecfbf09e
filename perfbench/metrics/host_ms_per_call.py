"""host_ms_per_call (kernel dispatch on the host): the mean host ms of a
call's root span (glow.sample, nfdp.sample or nf.train_step) in the traced
window, from the port's spans (perfbench/bench/spans.py): what the host
spends enqueueing a call."""

ROOTS = ("glow.sample", "nfdp.sample", "nf.train_step")


def read(ctx):
    spans = getattr(ctx, "spans", None)
    n = spans.count(ROOTS) if spans is not None else 0
    return spans.host_ms(ROOTS) / n if n else None
