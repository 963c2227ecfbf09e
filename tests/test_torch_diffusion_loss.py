"""The training half of the stage-2 diffusion prior in nfdpm_tpu_torch held
against nfdpm_tpu on the CPU: GaussianDiffusion.p_losses / loss over every
objective and option, the UNet's gradients leaf by leaf, and
DiffusionPrior.losses, sample_latents_given_start, interpolate_latents and
fit_formater_stats.

Every draw JAX makes from its keys (split, fold_in) is recomputed and
injected into the port. The objectives and options run over a small
analytic model in both frameworks (tests/_torch_port.py), so that each
compiles in a second; the UNet runs for real in the gradient and prior
tests. Tolerances: losses 1e-5 relative; gradients rtol 1e-4 and atol 1e-6
(fp32, sums in another order); chains atol 1e-4 and rtol 1e-5, as in
test_torch_diffusion.py; the latent stats 1e-9 relative (float64 on the
host on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, jax_model, model_weights, one_torch_thread, t, torch_model
from nfdpm_tpu.models import diffusion as jdiff
from nfdpm_tpu.models import formaters as jfmt
from nfdpm_tpu.models.diffusion_prior import DiffusionPrior as JDiffusionPrior
from nfdpm_tpu_torch import convert
from nfdpm_tpu_torch.models import diffusion as tdiff
from nfdpm_tpu_torch.models import formaters as tfmt
from nfdpm_tpu_torch.models.diffusion_prior import DiffusionPrior as TDiffusionPrior

SHAPE = (3, 4, 4, 6)
CHAIN_TOL = dict(atol=1e-4, rtol=1e-5)
VARIANTS = {
    "eps-l1": dict(objective="pred_noise", loss_type="l1"),
    "x0-l2": dict(objective="pred_x0", loss_type="l2"),
    "v-l2-p2": dict(objective="pred_v", loss_type="l2", p2_loss_weight_gamma=1.0),
    "eps-l2-learned-variance": dict(objective="pred_noise", loss_type="l2",
                                    learned_variance=True, vlb_loss_weight=2.0),
    "v-l1-self-cond-on": dict(objective="pred_v", loss_type="l1", self_condition=True),
    "eps-l2-self-cond-off": dict(objective="pred_noise", loss_type="l2",
                                 self_condition=True),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _loss_draws(key, shape, timesteps):
    """GaussianDiffusion.loss's draws from `key`: (t, noise, self-cond coin)."""
    k_t, k_p = jax.random.split(key)
    t_ = jax.random.randint(k_t, (shape[0],), 0, timesteps)
    k_noise, _, k_scdrop = jax.random.split(k_p, 3)
    return (np.asarray(t_), np.asarray(jax.random.normal(k_noise, shape)),
            bool(jax.random.bernoulli(k_scdrop)))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_gradients_match_jax(variant):
    kw = dict(image_size=SHAPE[1], channels=SHAPE[-1], timesteps=20, beta_schedule="cosine",
              auto_normalize=False, **VARIANTS[variant])
    out = SHAPE[-1] * (2 if kw.get("learned_variance") else 1)
    w = model_weights(SHAPE[-1], out, seed=1)
    gj = jdiff.GaussianDiffusion(jax_model, jdiff.DiffusionConfig(**kw))
    gt = tdiff.GaussianDiffusion(torch_model, tdiff.DiffusionConfig(**kw))
    img = np.random.default_rng(2).standard_normal(SHAPE).astype(np.float32)
    # a key whose self-conditioning coin falls as the variant asks
    want_sc = not variant.endswith("-off")
    key = next(k for k in (jax.random.PRNGKey(s) for s in range(64))
               if _loss_draws(k, SHAPE, 20)[2] == want_sc)
    steps, noise, sc = _loss_draws(key, SHAPE, 20)
    loss_j, grads_j = jax.value_and_grad(lambda p: gj.loss(p, key, jnp.asarray(img)))(
        jax.tree.map(jnp.asarray, w))
    params = {k: t(v).requires_grad_(True) for k, v in w.items()}
    loss_t = gt.loss(params, t(img), t=torch.from_numpy(steps).long(), noise=t(noise),
                     self_cond=sc)
    assert abs(loss_t.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    grads_t = torch.autograd.grad(loss_t, list(params.values()), allow_unused=True)
    for name, g in zip(params, grads_t):
        want = np.asarray(grads_j[name])
        if g is None:  # the self-conditioning weights of a model that never saw it
            assert not want.any()
        else:
            close(g, want, atol=1e-6, rtol=1e-4)


# -- the real UNet --------------------------------------------------------------

UNET = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=2)
DIFF = dict(timesteps=8, sampling_timesteps=4, loss_type="l2", beta_schedule="cosine")


@pytest.fixture(scope="module")
def priors():
    """(JAX prior, port prior, flax UNet trees, port params) over the latent
    parts (4,4,6) and (2,2,24) of an L2 flow at 8x8x3."""
    jdp = JDiffusionPrior(jfmt.IdentityFormater(L=2, in_channels=3, size=8),
                          dict(UNET, learned_variance=True), dict(DIFF, learned_variance=True))
    tdp = TDiffusionPrior(tfmt.IdentityFormater(L=2, in_channels=3, size=8),
                          dict(UNET, learned_variance=True), dict(DIFF, learned_variance=True))
    tparams = tdp.init_params(4, "cpu", requires_grad=True)
    flax = {"parts": tuple(convert.unet_to_flax(u) for u in tparams["parts"])}
    return jdp, tdp, flax, tparams


def _latents(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 4, 4, 6)).astype(np.float32),
            rng.standard_normal((2, 2, 2, 24)).astype(np.float32)]


def test_unet_gradients_match_jax_leaf_by_leaf(priors):
    """The hybrid loss (l2 plus the learned variances' VLB term) of part 0
    through the real UNet: the loss and every UNet gradient."""
    jdp, tdp, flax, tparams = priors
    z = _latents(0)[0]
    key = jax.random.PRNGKey(3)
    steps, noise, _ = _loss_draws(key, z.shape, DIFF["timesteps"])
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jdp.parts[0].loss(p, key, jnp.asarray(z))))(flax["parts"][0])
    unet = tparams["parts"][0]
    loss_t = tdp.parts[0].loss(unet, t(z), t=torch.from_numpy(steps).long(), noise=t(noise))
    assert abs(loss_t.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    names = [n for n, _ in unet.named_parameters()]
    grads = torch.autograd.grad(loss_t, list(unet.parameters()))
    as_module = tdp.build_unet(0)
    with torch.no_grad():
        for (name, p), g in zip(as_module.named_parameters(), grads):
            p.copy_(g)
    got = convert.unet_to_flax(as_module)
    leaves = jax.tree_util.tree_flatten_with_path(grads_j)[0]
    assert len(leaves) == len(names)
    for (path, want), have in zip(leaves, jax.tree.leaves(got)):
        np.testing.assert_allclose(have, np.asarray(want), rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_prior_losses_match_jax(priors):
    jdp, tdp, flax, tparams = priors
    latents = _latents(1)
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda p, zs: jdp.losses(p, key, zs))(flax, [jnp.asarray(z) for z in latents])
    draws = []
    for i, z in enumerate(latents):
        steps, noise, sc = _loss_draws(jax.random.fold_in(key, i), z.shape, DIFF["timesteps"])
        draws.append({"t": torch.from_numpy(steps).long(), "noise": t(noise), "self_cond": sc})
    got = tdp.losses(tparams, [t(z) for z in latents], draws=draws)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))


def test_given_start_and_interpolation_match_jax(priors):
    jdp, tdp, flax, tparams = priors
    z1, z2 = _latents(2), _latents(3)
    key = jax.random.PRNGKey(7)
    t_last = DIFF["timesteps"] - 1
    with torch.inference_mode():
        start_noise, mix_noise = [], []
        for i, z in enumerate(z1):
            k_q, k_loop = jax.random.split(jax.random.fold_in(key, i))
            start_noise.append([t(jax.random.normal(k_q, z.shape))] + [
                t(jax.random.normal(jax.random.fold_in(k_loop, s), z.shape))
                for s in range(t_last, -1, -1)])
            k_q1, k_q2, k_loop = jax.random.split(jax.random.fold_in(key, i), 3)
            mix_noise.append([t(jax.random.normal(k_q1, z.shape)),
                              t(jax.random.normal(k_q2, z.shape))] + [
                t(jax.random.normal(jax.random.fold_in(k_loop, s), z.shape))
                for s in range(t_last - 1, -1, -1)])
        got = tdp.sample_latents_given_start(tparams, [t(z) for z in z1], noise=start_noise)
        mixed = tdp.interpolate_latents(tparams, [t(z) for z in z1], [t(z) for z in z2],
                                        lam=0.3, noise=mix_noise)
    want = jdp.sample_latents_given_start(flax, key, [jnp.asarray(z) for z in z1])
    want_mixed = jdp.interpolate_latents(flax, key, [jnp.asarray(z) for z in z1],
                                         [jnp.asarray(z) for z in z2], lam=0.3)
    for a, b in zip(got + mixed, want + want_mixed):
        assert tuple(a.shape) == tuple(b.shape)
        close(a, np.asarray(b), **CHAIN_TOL)


@pytest.mark.parametrize("name", ["IdentityFormater", "CatFormater"])
def test_fit_formater_stats_matches_jax(name):
    rng = np.random.default_rng(4)
    shapes = [(5, 8, 8, 6), (5, 4, 4, 12), (5, 2, 2, 48)]
    batches = [[(rng.standard_normal(s) * (1 + i) + i).astype(np.float32)
                for i, s in enumerate(shapes)] for _ in range(3)]
    jformater = jfmt.get_formater(name)(L=3, in_channels=3, size=16)
    tformater = tfmt.get_formater(name)(L=3, in_channels=3, size=16)
    want = jfmt.fit_formater_stats(jformater, iter(batches))
    got = tfmt.fit_formater_stats(tformater, iter([[t(z) for z in b] for b in batches]))
    assert len(got) == len(want) == tformater.num_parts
    for (mean_g, std_g), (mean_w, std_w) in zip(got, want):
        np.testing.assert_allclose(mean_g, mean_w, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(std_g, std_w, rtol=1e-9)
    standardized = tformater.with_stats(got)
    assert standardized.stats == got and tformater.stats is None
    assert standardized.stats_log_sigma_total() == pytest.approx(
        jformater.with_stats(want).stats_log_sigma_total(), rel=1e-12)
    with pytest.raises(ValueError, match="empty"):
        tfmt.fit_formater_stats(tformater, iter([]))
