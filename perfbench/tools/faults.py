"""Faults planted in the program under the harness, to show that a cell's
check fails them: each is a context manager that patches one function of
the port for its duration.

    unchanged_step  training: the optimizer returns the state unchanged;
                    sampling: one Glow step of the inverse returns its input
    half_batch      training: the loss is the mean over half the batch;
                    sampling: the second half of each call's images repeats
                    the first
    altered         sampling: one served pixel moved by half the range;
                    stage 2: one latent value moved by 0.1
    nan_latent      stage 2: one latent value made NaN
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def plant(fault: str, entry: str):
    """The context manager that plants `fault` for a cell of kind `entry`."""
    from nfdpm_tpu_torch.ops import bijectors, quantize
    from nfdpm_tpu_torch.training import nf_trainer, optim

    if entry == "glow_train":
        if fault == "unchanged_step":
            return _patched(optim.Optimizer, "apply", lambda old: (
                lambda self, params, grads, state, *a, **k: dict(state, count=state["count"] + 1)))
        if fault == "half_batch":
            def make(old):
                def make_loss_fn(*a, **k):
                    loss = old(*a, **k)

                    def half(params, batch, generator=None, noise=None, fsdp=None):
                        n = batch.shape[0] // 2
                        return loss(params, batch[:n], generator,
                                    None if noise is None else noise[:n], fsdp)
                    return half
                return make_loss_fn
            return _patched(nf_trainer, "make_loss_fn", make)
    else:
        if fault == "unchanged_step":
            def make(old):
                first = []  # the first step the inverse runs: the same one in every call

                def step_inverse(params, y, *a, **k):
                    if not first:
                        first.append(params)
                    return y if params is first[0] else old(params, y, *a, **k)
                return step_inverse
            return _patched(bijectors, "step_inverse", make)
        if fault == "half_batch":
            def make(old):
                def postprocess(batch, n_bits):
                    out = old(batch, n_bits)
                    n = out.shape[0] // 2
                    out[n:2 * n] = out[:n]
                    return out
                return postprocess
            return _patched(quantize, "postprocess", make)
        if entry == "diffusion_sample" and fault in ("altered", "nan_latent"):
            from nfdpm_tpu_torch.models import diffusion_prior

            def make(old):
                def sample_latents(self, *a, **k):
                    out = old(self, *a, **k)
                    if fault == "altered":
                        out[0].view(-1)[0] += 0.1
                    else:
                        out[0].view(-1)[0] = float("nan")
                    return out
                return sample_latents
            return _patched(diffusion_prior.DiffusionPrior, "sample_latents", make)
        if fault == "altered":
            def make(old):
                def postprocess(batch, n_bits):
                    out = old(batch, n_bits)
                    out.view(-1)[0] = (out.view(-1)[0].to(int) + 128) % 256
                    return out
                return postprocess
            return _patched(quantize, "postprocess", make)
    raise ValueError(f"no fault {fault!r} for {entry}")


FAULTS = {"glow_train": ("unchanged_step", "half_batch"),
          "glow_sample": ("unchanged_step", "half_batch", "altered"),
          "diffusion_sample": ("unchanged_step", "half_batch", "altered", "nan_latent")}
