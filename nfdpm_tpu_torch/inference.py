"""Scoring and sampling for a Glow model: the serving path.

Counterparts of nfdpm_tpu/training/nf_trainer.py:make_eval_step and
make_sample_fn, and of tools/generate_samples.py:generate_batched.

    score : quantize -> dequantize -> glow.forward -> prior logp -> bits/dim
    sample: prior sample -> glow.inverse (split parts from their priors)
            -> postprocess to uint8

Both make_* functions resolve their device (CUDA unless the caller names another)
and turn TF32 off, so that the coupling CNN's cuDNN convolutions run in
full fp32 as the JAX reference does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import disable_tf32, resolve_device
from .models import glow as glow_m
from .models import prior as prior_m
from .ops import quantize as q


def _on(device: torch.device, a) -> torch.Tensor:
    """A tensor or array-like -> fp32 tensor on `device` (arrays copied)."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a, np.float32))
    return a.to(device=device, dtype=torch.float32)


def make_eval_step(cfg: glow_m.GlowConfig, n_bits: int = 5,
                   compat_three_channel_bpd: bool = True, device=None):
    """Per-example bits/dim of a batch, single-sample dequantization.

    Returns eval_step(params, batch, generator=None, noise=None) -> bpd [B],
    for images `batch` in [0, 1], [B, H, W, C]. `noise` is the U(0, 1)
    dequantization draw, else it comes from `generator`."""
    device = resolve_device(device)
    disable_tf32()
    n_bins = q.n_bins_of(n_bits)

    @torch.inference_mode()
    def ll_step(params, batch, generator=None, noise=None):
        batch = _on(device, batch)
        if noise is not None:
            noise = _on(device, noise)
        elif generator is None:
            raise ValueError("eval_step needs a generator or noise")
        x = q.preprocess(batch, n_bits)
        x = q.dequantize(generator, x, n_bits, noise)
        latents, ldj, logp = glow_m.forward(params["flow"], cfg, x)
        return ldj + logp + prior_m.gaussian_prior_logp(params["prior"], latents[-1])

    def eval_step(params, batch, generator=None, noise=None):
        ll = ll_step(params, batch, generator, noise)
        n_pixel = prior_m.n_pixels(batch.shape[1], batch.shape[-1],
                                   compat_three_channel_bpd)
        return (np.log(n_bins) * n_pixel - ll) * (np.log2(np.e) / n_pixel)

    return eval_step


def make_sample_fn(cfg: glow_m.GlowConfig, img_size: int, n_bits: int = 5,
                   device=None):
    """Sampler: returns sample(params, n, temperature=1.0, generator=None,
    noise=None) -> uint8 [n, H, W, C] on the device. `noise`, if given, is
    one N(0, 1) tensor per latent part, [z_1..z_{L-1}, z_final] in
    latent_shapes_nhwc order; otherwise every draw comes from `generator`."""
    device = resolve_device(device)
    disable_tf32()
    h, w, c = glow_m.latent_shapes_nhwc(cfg, img_size)[-1]

    @torch.inference_mode()
    def sample(params, n: int, temperature: float = 1.0,
               generator: Optional[torch.Generator] = None,
               noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        if noise is not None:
            noise = [_on(device, e) for e in noise]
        elif generator is None:
            raise ValueError("sample needs a generator or noise")
        z_last = prior_m.gaussian_prior_sample(
            params["prior"], generator, (n, h, w, c), temperature,
            None if noise is None else noise[-1])
        x = glow_m.inverse(params["flow"], cfg, [z_last], generator, temperature, noise)
        return q.postprocess(x, n_bits)

    sample.device = device
    return sample


def chunk_generator(seed: int, chunk: int, device: torch.device) -> torch.Generator:
    """A fresh generator for chunk `chunk` of a request with `seed`, so that
    no two chunks repeat samples and one seed always gives the same bytes."""
    state = np.random.SeedSequence([int(seed), int(chunk)]).generate_state(1, np.uint64)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]))
    return g


def generate_batched(sample_fn, params, n: int, batch: int, temperature: float,
                     seed: int) -> np.ndarray:
    """Fixed-batch generation: every chunk runs at `batch` (the last one is
    trimmed), each with a fresh generator. Returns uint8 NHWC on the host."""
    chunks, produced, salt = [], 0, 0
    while produced < n:
        take = min(batch, n - produced)
        g = chunk_generator(seed, salt, sample_fn.device)
        imgs = sample_fn(params, batch, temperature, generator=g)
        chunks.append(imgs[:take].cpu().numpy())
        produced += take
        salt += 1
    return np.concatenate(chunks, axis=0)
