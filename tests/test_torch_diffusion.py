"""The stage-2 diffusion prior of nfdpm_tpu_torch held against nfdpm_tpu on
the CPU: schedules, the sampler chains, the variational bound, the
formaters, and the whole serving slice (sampling and VLB bits/dim through a
Glow with a UNet prior per latent part).

The chains and the VLB are first held against JAX with a small analytic
model in place of the UNet, in both frameworks, so that each chain compiles
in a second; the UNet itself is held against JAX in test_torch_unet.py, and
the end-to-end tests run the real UNet. Every draw is made on the JAX side
from its keys (split, fold_in(k_loop, step), fold_in(key, part),
fold_in(key, t)) and injected into the port, since the two RNGs differ.
Tolerances: chain outputs and per-element VLB nats atol 1e-4 and rtol
1e-5: fp32 chains of at most 20 steps, whose x0 prediction
x_t / sqrt(alphā_t) - ... multiplies the model's rounding by up to
1 / sqrt(alphā_{T-1}), about 400 on the cosine schedule at T = 20 (the
measured gaps reach 2e-5); bits/dim 1e-3 (the ROADMAP gate);
uint8 samples at most one 5-bit bin (8 levels) apart on at most 0.1% of
the pixels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (close, jax_model, model_weights, one_torch_thread, randomize, t,
                         to_numpy_tree, torch_model)
from nfdpm_tpu.models import diffusion as jdiff
from nfdpm_tpu.models import formaters as jfmt
from nfdpm_tpu.models import glow as jglow
from nfdpm_tpu.models.diffusion_prior import DiffusionPrior as JDiffusionPrior
from nfdpm_tpu.models.nf_backbone import NFBackbone as JBackbone
from nfdpm_tpu.training import diffusion_trainer as dt
from nfdpm_tpu_torch import convert, inference
from nfdpm_tpu_torch.models import diffusion as tdiff
from nfdpm_tpu_torch.models import formaters as tfmt
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.models.diffusion_prior import DiffusionPrior as TDiffusionPrior
from nfdpm_tpu_torch.models.nf_backbone import NFBackbone as TBackbone

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


CHAIN_TOL = dict(atol=1e-4, rtol=1e-5)
T_STEPS, S_STEPS = 20, 5
PART_SHAPES = [(3, 4, 4, 6), (3, 2, 2, 24)]  # two latent parts, batch 3


VARIANTS = {
    "eps": dict(objective="pred_noise"),
    "v-learned-var-selfcond": dict(objective="pred_v", learned_variance=True,
                                   self_condition=True),
    "x0": dict(objective="pred_x0"),
}


def _pair(shape, variant, **extra):
    """(JAX process, port process, numpy weights) at one part shape."""
    _, h, _, c = shape
    kw = dict(image_size=h, channels=c, timesteps=T_STEPS, sampling_timesteps=S_STEPS,
              beta_schedule="cosine", auto_normalize=False, **VARIANTS[variant])
    kw.update(extra)
    out = c * (2 if kw.get("learned_variance") else 1)
    w = model_weights(c, out, seed=c)
    return (jdiff.GaussianDiffusion(jax_model, jdiff.DiffusionConfig(**kw)),
            tdiff.GaussianDiffusion(torch_model, tdiff.DiffusionConfig(**kw)), w)


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape))


def _chain_noise(method, key, shape, gd):
    """The draws JAX's chain makes from `key`, in the port's order: x_T, then
    one per step."""
    k_init, k_loop = jax.random.split(key)
    noise = [_normal(k_init, shape)]
    if method == "ancestral":
        noise += [_normal(jax.random.fold_in(k_loop, s), shape)
                  for s in range(gd.num_timesteps - 1, -1, -1)]
    elif method == "ddim":
        noise += [_normal(jax.random.fold_in(k_loop, i), shape)
                  for i in range(gd.sampling_timesteps)]
    return noise


# -- schedules and helpers ----------------------------------------------------

@pytest.mark.parametrize("schedule", ["linear", "cosine", "sigmoid"])
def test_schedule_matches_jax(schedule):
    a, b = jdiff.make_schedule(schedule, 50, 0.5, 1.0), tdiff.make_schedule(schedule, 50, 0.5, 1.0)
    for name in a._fields:
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name), err_msg=name)


def test_normal_kl_and_discretized_likelihood_match_jax():
    rng = np.random.default_rng(0)
    m1, m2, x = (rng.standard_normal((4, 5)).astype(np.float32) for _ in range(3))
    lv1, lv2 = (rng.uniform(-3, 1, (4, 5)).astype(np.float32) for _ in range(2))
    close(tdiff.normal_kl(t(m1), t(lv1), t(m2), t(lv2)),
          jdiff.normal_kl(m1, lv1, m2, lv2), atol=1e-5, rtol=1e-5)
    close(tdiff.normal_kl(t(m1), -1.5, 0.0, 0.0), jdiff.normal_kl(m1, -1.5, 0.0, 0.0),
          atol=1e-5, rtol=1e-5)
    close(tdiff.gaussian_log_likelihood(t(x), t(m1), t(0.5 * lv1)),
          jdiff.gaussian_log_likelihood(x, m1, 0.5 * lv1), atol=1e-5, rtol=1e-5)


# -- sampler chains on two parts ----------------------------------------------

CHAINS = [("ddim", 0.0), ("ddim", 1.0), ("ancestral", 0.0), ("dpm++", 0.0)]
CHAIN_IDS = ["ddim-eta0", "ddim-eta1", "ancestral", "dpm++"]


@pytest.mark.parametrize("variant", ["eps", "v-learned-var-selfcond"])
@pytest.mark.parametrize("method,eta", CHAINS, ids=CHAIN_IDS)
def test_sampler_chain_matches_jax(method, eta, variant):
    for part, shape in enumerate(PART_SHAPES):
        jgd, tgd, w = _pair(shape, variant, ddim_sampling_eta=eta, sampling_method=method)
        key = jax.random.fold_in(jax.random.PRNGKey(11), part)
        expected = jgd.sample(w, key, shape[0])
        noise = [t(e) for e in _chain_noise(method, key, shape, jgd)]
        got = tgd.sample({k: t(v) for k, v in w.items()}, shape[0], noise=noise)
        assert got.shape == shape
        close(got, expected, **CHAIN_TOL)


def test_sample_auto_dispatch_and_generator_draws():
    shape = PART_SHAPES[0]
    _, tgd, w = _pair(shape, "x0", ddim_sampling_eta=1.0)
    tw = {k: t(v) for k, v in w.items()}
    assert tgd.is_ddim_sampling
    gen = lambda: torch.Generator().manual_seed(5)
    a, b = tgd.sample(tw, 3, gen()), tgd.ddim_sample(tw, shape, gen())
    assert torch.equal(a, b)
    _, full, _ = _pair(shape, "x0", sampling_timesteps=T_STEPS)
    assert not full.is_ddim_sampling
    assert torch.equal(full.sample(tw, 3, gen()), full.p_sample_loop(tw, shape, gen()))
    with pytest.raises(ValueError):
        tgd.sample(tw, 3)  # neither a generator nor noise


# -- the variational bound ------------------------------------------------------

VLB_CASES = [("discretized", True, "eps"), ("discretized", False, "eps"),
             ("density", True, "eps"), ("density", False, "eps"),
             ("discretized", False, "v-learned-var-selfcond")]


@pytest.mark.parametrize("decoder,clip,variant", VLB_CASES,
                         ids=[f"{d}-{'clip' if c else 'noclip'}-{v}" for d, c, v in VLB_CASES])
def test_neg_log_likelihood_matches_jax(decoder, clip, variant):
    """T = 10 in chunks of 4: two folded chunks and the T % 4 remainder call."""
    shape = PART_SHAPES[0]
    jgd, tgd, w = _pair(shape, variant, timesteps=10, sampling_timesteps=10,
                        vlb_time_chunk=4, vlb_decoder=decoder, vlb_clip_denoised=clip)
    x0 = (1.5 * np.random.default_rng(3).standard_normal(shape)).astype(np.float32)
    sc = (0.3 * np.random.default_rng(4).standard_normal(shape)).astype(np.float32)
    sc = sc if jgd.cfg.self_condition else None
    key = jax.random.PRNGKey(9)
    expected = jgd.neg_log_likelihood(w, key, jnp.asarray(x0),
                                      None if sc is None else jnp.asarray(sc))
    noise = [t(_normal(jax.random.fold_in(key, s), shape)) for s in range(10)]
    got = tgd.neg_log_likelihood({k: t(v) for k, v in w.items()}, t(x0), noise=noise,
                                 x_self_cond=None if sc is None else t(sc))
    assert got.shape == (shape[0],)
    close(got, expected, **CHAIN_TOL)


# -- formaters --------------------------------------------------------------------

def _stats(formater, seed):
    rng = np.random.default_rng(seed)
    return tuple((tuple(float(v) for v in rng.normal(0.0, 0.2, c)),
                  tuple(float(v) for v in rng.uniform(0.5, 2.0, c)))
                 for (_h, _w, c) in formater.input_shapes)


@pytest.mark.parametrize("name", ["IdentityFormater", "CatFormater"])
@pytest.mark.parametrize("levels", [2, 3])
def test_formaters_match_jax(name, levels):
    jf = jfmt.get_formater(name)(L=levels, in_channels=3, size=16)
    jf = jf.with_stats(_stats(jf, levels))
    tf = tfmt.get_formater(name)(L=levels, in_channels=3, size=16,
                                 stats=tfmt.stats_from_json(
                                     [[list(m), list(s)] for m, s in jf.stats]))
    assert tf.input_shapes == jf.input_shapes and tf.num_parts == jf.num_parts
    lats = [np.random.default_rng(i).standard_normal((2, *s)).astype(np.float32)
            for i, s in enumerate(jf.latent_shapes)]
    processed_j = jf.process_latents([jnp.asarray(z) for z in lats])
    processed_t = tf.process_latents([t(z) for z in lats])
    for a, b in zip(processed_t, processed_j):
        close(a, b, atol=1e-6)
    for a, z in zip(tf.postprocess(processed_t), lats):
        close(a, z, atol=1e-5)
    assert tf.stats_log_sigma_total() == pytest.approx(jf.stats_log_sigma_total(), rel=1e-12)


# -- the whole slice: Glow L2/K1/w16, 16x16x3, a UNet per part ---------------------

IMG, BATCH, N_BITS = 16, 3, 5
UNET_KW = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=2)
DIFF_KW = dict(timesteps=10, sampling_timesteps=5, beta_schedule="cosine",
               ddim_sampling_eta=1.0, vlb_time_chunk=4)
SLICES = {"identity": ("IdentityFormater", False), "cat-stats": ("CatFormater", True)}


@pytest.fixture(scope="module", params=list(SLICES))
def stage2(request, tmp_path_factory):
    name, with_stats = SLICES[request.param]
    gkw = dict(in_channels=3, levels=2, steps=1, coupling_width=16)
    jformater = jfmt.get_formater(name)(L=2, in_channels=3, size=IMG)
    if with_stats:
        jformater = jformater.with_stats(_stats(jformater, 1))
    jdp = JDiffusionPrior(jformater, dict(UNET_KW), dict(DIFF_KW))
    tformater = tfmt.get_formater(name)(L=2, in_channels=3, size=IMG, stats=jformater.stats)
    tdp = TDiffusionPrior(tformater, dict(UNET_KW), dict(DIFF_KW))
    # the UNet trees come from the port's seeded init (flax's init would
    # compile for seconds); a tree that did not fit the flax modules would
    # make their apply fail
    unets = {"parts": tuple(convert.unet_to_flax(u)
                            for u in tdp.init_params(2, "cpu")["parts"])}
    tree = randomize(to_numpy_tree({"flow": jglow.init_glow(0, jglow.GlowConfig(**gkw)),
                                    "diffusion": unets}), seed=3, scale=0.02)
    path = tmp_path_factory.mktemp("stage2") / "weights.npz"
    convert.save_npz(path, tree)
    tparams = convert.diffusion_from_jax_params(convert.load_npz(path), tdp, "cpu")
    return dict(
        jbb=JBackbone(jglow.GlowConfig(**gkw), IMG), jdp=jdp,
        jparams=jax.tree.map(jnp.asarray, tree), tree=tree,
        tbb=TBackbone(tglow.GlowConfig(**gkw), IMG), tdp=tdp, tparams=tparams)


def test_diffusion_params_roundtrip_through_npz(stage2):
    back = convert.diffusion_to_jax_params(stage2["tparams"])
    tree = stage2["tree"]
    assert jax.tree.structure(back) == jax.tree.structure(dict(tree, prior={}))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_diffusion_sample_fn_matches_jax(stage2):
    """diffusion_trainer.make_sample_fn against inference.make_diffusion_sample_fn,
    given the DDIM chains' draws of every part."""
    s = stage2
    key, salt = jax.random.PRNGKey(7), 1
    jsample = dt.make_sample_fn(s["jbb"], s["jdp"], dt.DiffusionTrainConfig(n_bits=N_BITS))
    imgs_j = np.asarray(jsample(s["jparams"], key, BATCH, 1.0, salt))
    k_diff, _ = jax.random.split(jax.random.fold_in(key, salt))
    noise = [_chain_noise("ddim", jax.random.fold_in(k_diff, i), (BATCH, h, w, c), gd)
             for i, ((h, w, c), gd) in enumerate(zip(s["jdp"].formater.input_shapes,
                                                      s["jdp"].parts))]
    sample = inference.make_diffusion_sample_fn(s["tbb"], s["tdp"], N_BITS, device="cpu")
    imgs_t, latents = sample(s["tparams"], BATCH, 1.0, noise=noise, return_latents=True)
    assert [tuple(z.shape[1:]) for z in latents] == s["tbb"].latent_shapes
    imgs_t = imgs_t.numpy()
    assert imgs_t.dtype == np.uint8 and imgs_t.shape == imgs_j.shape == (BATCH, IMG, IMG, 3)
    diff = np.abs(imgs_t.astype(int) - imgs_j.astype(int))
    assert diff.max() <= 8 and np.mean(diff > 0) <= 1e-3


class _OneBatch:
    def __init__(self, imgs):
        self.imgs = imgs

    def padded_batches(self):
        yield self.imgs, np.zeros(len(self.imgs), np.int32), len(self.imgs)


def test_vlb_eval_step_matches_jax(stage2):
    """calculate_bpd_with_diff_prior against inference.make_vlb_eval_step,
    given the dequantization draw and every part's per-t draws."""
    s = stage2
    imgs = np.random.default_rng(5).integers(0, 256, (BATCH, IMG, IMG, 3)).astype(np.float32) / 255
    key = jax.random.PRNGKey(13)
    bpd_j = dt.calculate_bpd_with_diff_prior(
        s["jbb"], s["jdp"], dt.DiffusionTrainConfig(n_bits=N_BITS), s["jparams"],
        _OneBatch(imgs), key)
    k_dq, k_nll = jax.random.split(jax.random.fold_in(key, 0))
    noise = np.asarray(jax.random.uniform(k_dq, imgs.shape, jnp.float32))
    vlb_noise = [[_normal(jax.random.fold_in(jax.random.fold_in(k_nll, i), step), (BATCH, h, w, c))
                  for step in range(DIFF_KW["timesteps"])]
                 for i, (h, w, c) in enumerate(s["jdp"].formater.input_shapes)]
    eval_step = inference.make_vlb_eval_step(s["tbb"], s["tdp"], N_BITS, device="cpu")
    bpd_t = eval_step(s["tparams"], t(imgs), noise=noise, vlb_noise=vlb_noise)
    assert bpd_t.shape == (BATCH,) and bool(torch.isfinite(bpd_t).all())
    assert abs(float(bpd_t.mean()) - bpd_j) <= 1e-3


def test_kernel_and_plain_routes_agree(stage2):
    """use_kernels=False takes the plain linear attention; on the CPU both
    routes run the plain version, so they agree exactly."""
    s = stage2
    plain = dataclasses.replace(s["tdp"], use_kernels=False)
    imgs = torch.rand((2, IMG, IMG, 3), generator=torch.Generator().manual_seed(1))
    a = inference.make_vlb_eval_step(s["tbb"], s["tdp"], device="cpu")(
        s["tparams"], imgs, torch.Generator().manual_seed(2))
    b = inference.make_vlb_eval_step(s["tbb"], plain, device="cpu")(
        s["tparams"], imgs, torch.Generator().manual_seed(2))
    assert torch.equal(a, b)


def test_generate_batched_over_the_diffusion_sampler(stage2):
    s = stage2
    sample = inference.make_diffusion_sample_fn(s["tbb"], s["tdp"], N_BITS, device="cpu")
    a = inference.generate_batched(sample, s["tparams"], 5, 3, 1.0, seed=3)
    b = inference.generate_batched(sample, s["tparams"], 5, 3, 1.0, seed=3)
    c = inference.generate_batched(sample, s["tparams"], 5, 3, 1.0, seed=4)
    assert a.shape == (5, IMG, IMG, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
