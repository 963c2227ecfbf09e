"""DiffusionPrior.evaluate_neg_log_likelihood of nfdpm_tpu_torch held against
nfdpm_tpu's on the CPU: the VLB of each formater-processed part divided by
its dim count, for the CatFormater and the IdentityFormater, with and
without standardization stats.

The UNets are the port's seeded ones, handed to the JAX package through
convert.unet_to_flax; the latents are numpy draws from a seed; every
per-timestep draw of the VLB is the JAX package's
(fold_in(fold_in(key, part), t)), injected into the port, as
test_torch_diffusion.py::test_neg_log_likelihood_matches_jax injects them.
Tolerance: atol 1e-4 / rtol 1e-5 (CHAIN_TOL there); the weighted sum
against neg_log_likelihood_nats rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, one_torch_thread, t
from nfdpm_tpu.models import formaters as jfmt
from nfdpm_tpu.models.diffusion_prior import DiffusionPrior as JDiffusionPrior
from nfdpm_tpu_torch import convert
from nfdpm_tpu_torch.models import formaters as tfmt
from nfdpm_tpu_torch.models.diffusion_prior import DiffusionPrior as TDiffusionPrior


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


CHAIN_TOL = dict(atol=1e-4, rtol=1e-5)
IMG, BATCH, LEVELS = 8, 2, 2
UNET_KW = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=2)
DIFF_KW = dict(timesteps=6, sampling_timesteps=3, beta_schedule="cosine", vlb_time_chunk=4)
CASES = [("CatFormater", False), ("CatFormater", True), ("IdentityFormater", False),
         ("IdentityFormater", True)]


def _stats(formater, seed):
    rng = np.random.default_rng(seed)
    return tuple((tuple(float(v) for v in rng.normal(0.0, 0.2, c)),
                  tuple(float(v) for v in rng.uniform(0.5, 2.0, c)))
                 for (_h, _w, c) in formater.input_shapes)


def _priors(name, with_stats):
    jformater = jfmt.get_formater(name)(L=LEVELS, in_channels=3, size=IMG)
    if with_stats:
        jformater = jformater.with_stats(_stats(jformater, 5))
    tformater = tfmt.get_formater(name)(L=LEVELS, in_channels=3, size=IMG,
                                        stats=jformater.stats)
    jdp = JDiffusionPrior(jformater, dict(UNET_KW), dict(DIFF_KW))
    tdp = TDiffusionPrior(tformater, dict(UNET_KW), dict(DIFF_KW))
    tparams = tdp.init_params(3, "cpu")
    jparams = {"parts": tuple(jax.tree.map(jnp.asarray, convert.unet_to_flax(u))
                              for u in tparams["parts"])}
    latents = [np.random.default_rng(10 + i).standard_normal((BATCH, *s)).astype(np.float32)
               for i, s in enumerate(jformater.latent_shapes)]
    return jdp, jparams, tdp, tparams, latents


def _vlb_noise(jdp, key):
    """Part i's draw at timestep s, as the JAX package makes it."""
    return [[t(jax.random.normal(jax.random.fold_in(jax.random.fold_in(key, i), s),
                                 (BATCH, h, w, c)))
             for s in range(DIFF_KW["timesteps"])]
            for i, (h, w, c) in enumerate(jdp.formater.input_shapes)]


@pytest.mark.parametrize("name,with_stats", CASES)
def test_evaluate_neg_log_likelihood_matches_jax(name, with_stats):
    jdp, jparams, tdp, tparams, latents = _priors(name, with_stats)
    key = jax.random.PRNGKey(7)
    want = jdp.evaluate_neg_log_likelihood(jparams, key, [jnp.asarray(z) for z in latents])
    with torch.no_grad():
        got = tdp.evaluate_neg_log_likelihood(tparams, [t(z) for z in latents],
                                              noise=_vlb_noise(jdp, key))
    assert len(got) == len(want) == tdp.num_parts
    for a, b in zip(got, want):
        assert a.shape == (BATCH,)
        close(a, b, **CHAIN_TOL)


@pytest.mark.parametrize("name,with_stats", CASES)
def test_per_part_values_weighted_give_the_total_nats(name, with_stats):
    """Each value is the part's VLB (a sum of per-dim terms) over its dims,
    so dims**2 weights it into neg_log_likelihood_nats; the formater's
    sum(log std) is added once, as in the JAX package."""
    jdp, _, tdp, tparams, latents = _priors(name, with_stats)
    noise = _vlb_noise(jdp, jax.random.PRNGKey(11))
    lat = [t(z) for z in latents]
    with torch.no_grad():
        per_part = tdp.evaluate_neg_log_likelihood(tparams, lat, noise=noise)
        nats = tdp.neg_log_likelihood_nats(tparams, lat, noise=noise)
    dims = [float(np.prod(s)) for s in tdp.formater.input_shapes]
    total = sum(v * d * d for v, d in zip(per_part, dims)) + \
        tdp.formater.stats_log_sigma_total()
    close(total, nats, atol=0.0, rtol=1e-5)
    assert (tdp.formater.stats_log_sigma_total() != 0.0) == with_stats


def test_per_part_values_draw_from_the_generator():
    """Without injected noise the parts draw from `generator` in turn: the
    same seed gives the same values."""
    _, _, tdp, tparams, latents = _priors("IdentityFormater", False)
    lat = [t(z) for z in latents]
    with torch.no_grad():
        a = tdp.evaluate_neg_log_likelihood(tparams, lat, torch.Generator().manual_seed(3))
        b = tdp.evaluate_neg_log_likelihood(tparams, lat, torch.Generator().manual_seed(3))
    for x, y in zip(a, b):
        assert torch.equal(x, y) and bool(torch.isfinite(x).all())
