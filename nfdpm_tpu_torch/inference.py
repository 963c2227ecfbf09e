"""Scoring and sampling: the serving path of a Glow model and of a Glow
with a diffusion prior (stage 2).

Counterparts of nfdpm_tpu/training/nf_trainer.py:make_eval_step and
make_sample_fn, of diffusion_trainer.py:make_sample_fn and the per-batch
step of calculate_bpd_with_diff_prior, and of
tools/generate_samples.py:generate_batched.

    score : quantize -> dequantize -> glow.forward -> prior logp -> bits/dim
    sample: prior sample -> glow.inverse (split parts from their priors)
            -> postprocess to uint8
    stage-2 score : quantize -> dequantize -> glow.forward (no split priors)
            -> diffusion VLB of the latent parts -> bits/dim
    stage-2 sample: per-part diffusion chains -> formater.postprocess
            -> glow.inverse with every part given -> postprocess to uint8

Every make_* function resolves its device (CUDA unless the caller names
another) and applies the process's matmul precision
(nfdpm_tpu_torch.apply_matmul_precision): TF32 off unless an entry point
was given model.training.matmul_precision=high, so that the cuDNN
convolutions (the coupling CNN, the UNet) run in full fp32 as the JAX
reference does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import apply_matmul_precision, resolve_device
from .models import glow as glow_m
from .models import prior as prior_m
from .models.diffusion_prior import DiffusionPrior
from .models.nf_backbone import NFBackbone
from .ops import quantize as q
from .utils.profiling import annotate


def _on(device: torch.device, a) -> torch.Tensor:
    """A tensor or array-like -> fp32 tensor on `device` (arrays copied)."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a, np.float32))
    return a.to(device=device, dtype=torch.float32)


def make_eval_step(cfg: glow_m.GlowConfig, n_bits: int = 5,
                   compat_three_channel_bpd: bool = True, device=None, model=None):
    """Per-example bits/dim of a batch, single-sample dequantization.

    Returns eval_step(params, batch, generator=None, noise=None) -> bpd [B],
    for images `batch` in [0, 1], [B, H, W, C]. `noise` is the U(0, 1)
    dequantization draw, else it comes from `generator`. The log-likelihood
    behind it is `eval_step.ll` (same arguments), for combining several
    draws (training/nf_trainer.py:calculate_bpd). `model`: the model axis
    when the parameters are a rank's slabs (parallel/tensor_parallel.py)."""
    device = resolve_device(device)
    apply_matmul_precision()
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
        latents, ldj, logp = glow_m.forward(params["flow"], cfg, x, model=model)
        return ldj + logp + prior_m.gaussian_prior_logp(params["prior"], latents[-1])

    def eval_step(params, batch, generator=None, noise=None):
        ll = ll_step(params, batch, generator, noise)
        n_pixel = prior_m.n_pixels(batch.shape[1], batch.shape[-1],
                                   compat_three_channel_bpd)
        return (np.log(n_bins) * n_pixel - ll) * (np.log2(np.e) / n_pixel)

    eval_step.ll = ll_step
    eval_step.n_bins = n_bins
    eval_step.compat = compat_three_channel_bpd
    eval_step.device = device
    return eval_step


def make_sample_fn(cfg: glow_m.GlowConfig, img_size: int, n_bits: int = 5,
                   device=None, model=None):
    """Sampler: returns sample(params, n, temperature=1.0, generator=None,
    noise=None) -> uint8 [n, H, W, C] on the device. `noise`, if given, is
    one N(0, 1) tensor per latent part, [z_1..z_{L-1}, z_final] in
    latent_shapes_nhwc order; otherwise every draw comes from `generator`.
    `model` as in make_eval_step."""
    device = resolve_device(device)
    apply_matmul_precision()
    h, w, c = glow_m.latent_shapes_nhwc(cfg, img_size)[-1]

    @torch.inference_mode()
    def sample(params, n: int, temperature: float = 1.0,
               generator: Optional[torch.Generator] = None,
               noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        with annotate("glow.sample"):
            if noise is not None:
                noise = [_on(device, e) for e in noise]
            elif generator is None:
                raise ValueError("sample needs a generator or noise")
            z_last = prior_m.gaussian_prior_sample(
                params["prior"], generator, (n, h, w, c), temperature,
                None if noise is None else noise[-1])
            x = glow_m.inverse(params["flow"], cfg, [z_last], generator, temperature, noise,
                               model)
            with annotate("quantize.postprocess"):
                return q.postprocess(x, n_bits)

    sample.device = device
    return sample


def make_diffusion_sample_fn(backbone: NFBackbone, dp: DiffusionPrior, n_bits: int = 5,
                             device=None):
    """Stage-2 sampler: returns sample(params, n, temperature=1.0,
    generator=None, noise=None, return_latents=False) -> uint8 [n, H, W, C]
    on the device (and the latent parts, when asked). `params` is
    {"flow", "diffusion": {"parts": [Unet, ...]}}; `noise[i]` is part i's
    injected chain noise (models/diffusion.py), otherwise every draw comes
    from `generator`. The flow inverse gets every latent part, so
    `temperature` changes nothing, as in the JAX package."""
    device = resolve_device(device)
    apply_matmul_precision()

    @torch.inference_mode()
    def sample(params, n: int, temperature: float = 1.0,
               generator: Optional[torch.Generator] = None,
               noise: Optional[Sequence[Sequence[torch.Tensor]]] = None,
               return_latents: bool = False):
        with annotate("nfdp.sample"):
            if noise is not None:
                noise = [[_on(device, e) for e in part] for part in noise]
            elif generator is None:
                raise ValueError("sample needs a generator or noise")
            latents = dp.sample_latents(params["diffusion"], n, generator, noise)
            x = backbone.invert(params["flow"], latents, temperature=temperature)
            with annotate("quantize.postprocess"):
                images = q.postprocess(x, n_bits)
            return (images, latents) if return_latents else images

    sample.device = device
    return sample


def make_vlb_eval_step(backbone: NFBackbone, dp: DiffusionPrior, n_bits: int = 5,
                       compat_three_channel_bpd: bool = True, device=None):
    """Per-example variational-bound bits/dim of flow + diffusion prior:
    [log(n_bins) n_pixel - (ldj - prior VLB nats)] log2(e) / n_pixel.

    Returns eval_step(params, batch, generator=None, noise=None,
    vlb_noise=None) -> bpd [B] for images `batch` in [0, 1], [B, H, W, C].
    `noise` is the U(0, 1) dequantization draw and `vlb_noise[i][t]` part
    i's N(0, 1) draw at timestep t; what is not given comes from
    `generator`."""
    device = resolve_device(device)
    apply_matmul_precision()
    n_bins = q.n_bins_of(n_bits)
    n_pixel = prior_m.n_pixels(backbone.img_size, backbone.cfg.in_channels,
                               compat_three_channel_bpd)

    @torch.inference_mode()
    def eval_step(params, batch, generator: Optional[torch.Generator] = None,
                  noise=None, vlb_noise=None):
        if generator is None and (noise is None or vlb_noise is None):
            raise ValueError("eval_step needs a generator or all of its noise")
        batch = _on(device, batch)
        if noise is not None:
            noise = _on(device, noise)
        if vlb_noise is not None:
            vlb_noise = [[_on(device, e) for e in part] for part in vlb_noise]
        x = q.preprocess(batch, n_bits)
        x = q.dequantize(generator, x, n_bits, noise)
        latents, ldj = backbone.transform(params["flow"], x)
        ll = ldj - dp.neg_log_likelihood_nats(params["diffusion"], latents, generator,
                                              vlb_noise)
        return (np.log(n_bins) * n_pixel - ll) * (np.log2(np.e) / n_pixel)

    return eval_step


def reseed(generator: torch.Generator, *words: int) -> torch.Generator:
    """Seed `generator` from the non-negative integers `words`, so that what
    it draws next is a pure function of them; returns it."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(1, np.uint64)
    generator.manual_seed(int(state[0]))
    return generator


def chunk_generator(seed: int, chunk: int, device: torch.device) -> torch.Generator:
    """A fresh generator for chunk `chunk` of a request with `seed`, so that
    no two chunks repeat samples and one seed always gives the same bytes."""
    return reseed(torch.Generator(device=device), seed, chunk)


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
