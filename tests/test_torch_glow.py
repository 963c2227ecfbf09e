"""The whole serving slice of nfdpm_tpu_torch held against nfdpm_tpu on the CPU.

Glow L2/K2, coupling width 32, 8x8x3, batch 4; PLU and full-W 1x1 convs,
learned and standard-normal priors. Weights come from the JAX package's
init (with its zero leaves given small seeded values) through
convert.from_jax_params. The JAX flow runs its Pallas route
(use_pallas=True, interpret mode on the CPU); the port runs its kernel route,
whose wrappers take their plain versions on CPU tensors. Random draws are
made on the JAX side and handed to the port, since the two RNGs differ.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, one_torch_thread, randomize, t, to_numpy_tree
from nfdpm_tpu.models import glow as jglow
from nfdpm_tpu.models import prior as jprior
from nfdpm_tpu.training import nf_trainer as nft
from nfdpm_tpu_torch import convert, inference
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.models import prior as tprior

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


LDJ_TOL = dict(rtol=1e-5, atol=1e-4)
IMG, BATCH = 8, 4
CASES = [("plu", True), ("plu", False), ("full", True), ("full", False)]
IDS = [f"{p}-{'learned' if lp else 'std'}" for p, lp in CASES]


def _configs(param, learn_prior):
    kw = dict(in_channels=3, levels=2, steps=2, coupling_width=32,
              learn_prior=learn_prior, invconv_param=param)
    return jglow.GlowConfig(use_pallas=True, **kw), tglow.GlowConfig(use_kernels=True, **kw)


def _setup(param, learn_prior, seed=0):
    jcfg, tcfg = _configs(param, learn_prior)
    flow = jglow.init_glow(seed, jcfg)
    prior = jprior.init_gaussian_prior(tglow.final_channels(tcfg), learn_prior)
    tree = randomize(to_numpy_tree({"flow": flow, "prior": prior}), seed=seed + 1)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = convert.from_jax_params(tree, "cpu")
    return jcfg, tcfg, tree, jparams, tparams


def _images(seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (BATCH, IMG, IMG, 3)).astype(np.float32) / 255.0


@pytest.mark.parametrize("param,learn_prior", CASES, ids=IDS)
def test_convert_roundtrips_through_npz(tmp_path, param, learn_prior):
    _, _, tree, _, tparams = _setup(param, learn_prior)
    path = tmp_path / "glow.npz"
    convert.save_npz(path, tree)
    back = convert.from_jax_params(convert.load_npz(path), "cpu")
    a, b = jax.tree.leaves(tparams), jax.tree.leaves(back)
    assert jax.tree.structure(tparams) == jax.tree.structure(back) and len(a) == len(b)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    again = convert.to_jax_params(back)
    assert jax.tree.structure(again) == jax.tree.structure(tree)
    for u, v in zip(jax.tree.leaves(again), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("param", ["plu", "full"])
def test_init_glow_matches_jax(param):
    jcfg, tcfg = _configs(param, True)
    jflow = to_numpy_tree(jglow.init_glow(5, jcfg))
    tflow = convert.to_jax_params({"flow": tglow.init_glow(5, tcfg, "cpu"), "prior": {}})
    for u, v in zip(jax.tree.leaves(tflow["flow"]), jax.tree.leaves(jflow)):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("param,learn_prior", CASES, ids=IDS)
def test_forward_matches_jax(param, learn_prior):
    jcfg, tcfg, _, jparams, tparams = _setup(param, learn_prior)
    x = _images() - 0.5
    lat_j, ldj_j, logp_j = jglow.forward(jparams["flow"], jcfg, jnp.asarray(x))
    lat_t, ldj_t, logp_t = tglow.forward(tparams["flow"], tcfg, t(x))
    assert [tuple(z.shape) for z in lat_t] == [(BATCH, *s) for s in
                                               tglow.latent_shapes_nhwc(tcfg, IMG)]
    for a, b in zip(lat_t, lat_j):
        close(a, b)
    close(ldj_t, ldj_j, **LDJ_TOL)
    close(logp_t, logp_j, **LDJ_TOL)
    close(tprior.gaussian_prior_logp(tparams["prior"], lat_t[-1]),
          jprior.gaussian_prior_logp(jparams["prior"], lat_j[-1]), **LDJ_TOL)


@pytest.mark.parametrize("param,learn_prior", CASES, ids=IDS)
def test_eval_bpd_matches_jax(param, learn_prior):
    """nf_trainer.make_eval_step against inference.make_eval_step, the
    port fed the very uniform draw that the JAX step makes from its key."""
    jcfg, tcfg, _, jparams, tparams = _setup(param, learn_prior)
    imgs = _images()
    key, salt = jax.random.PRNGKey(4), np.int32(2)
    bpd_j = nft.make_eval_step(jcfg, nft.NFTrainConfig(n_bits=5))(
        jparams, jnp.asarray(imgs), key, salt)
    noise = jax.random.uniform(jax.random.fold_in(key, salt), imgs.shape, jnp.float32)
    eval_t = inference.make_eval_step(tcfg, n_bits=5, device="cpu")
    bpd_t = eval_t(tparams, t(imgs), noise=np.asarray(noise))
    assert bpd_t.shape == (BATCH,)
    close(bpd_t, bpd_j, atol=1e-4)


@pytest.mark.parametrize("param,learn_prior", CASES, ids=IDS)
def test_inverse_matches_jax(param, learn_prior):
    jcfg, tcfg, _, jparams, tparams = _setup(param, learn_prior)
    shapes = tglow.latent_shapes_nhwc(tcfg, IMG)
    lats = [np.random.default_rng(10 + i).standard_normal((BATCH, *s)).astype(np.float32)
            for i, s in enumerate(shapes)]
    x_j = jglow.inverse(jparams["flow"], jcfg, [jnp.asarray(z) for z in lats])
    x_t = tglow.inverse(tparams["flow"], tcfg, [t(z) for z in lats])
    close(x_t, x_j)
    lat_back, _, _ = tglow.forward(tparams["flow"], tcfg, x_t)
    for a, b in zip(lat_back, lats):
        close(a, b, atol=2e-3)


def _jax_sample_noise(key, salt, cfg, n):
    """The N(0, 1) draws nf_trainer.make_sample_fn makes from (key, salt),
    in latent-part order: split parts from fold_in(k2, i), the final part
    from k1."""
    k1, k2 = jax.random.split(jax.random.fold_in(key, salt))
    shapes = jglow.latent_shapes_nhwc(cfg, IMG)
    blocks = cfg.levels - 1
    noise = [None] * len(shapes)
    noise[-1] = jax.random.normal(k1, (n, *shapes[-1]), jnp.float32)
    for i in range(blocks):  # block i counted from the last one
        idx = -(i + 2)
        noise[idx] = jax.random.normal(jax.random.fold_in(k2, i), (n, *shapes[idx]),
                                       jnp.float32)
    return [np.asarray(e) for e in noise]


@pytest.mark.parametrize("param,learn_prior", CASES, ids=IDS)
def test_sample_fn_matches_jax(param, learn_prior):
    """The whole sampling slice: nf_trainer.make_sample_fn's uint8 images
    against the port's, given the same normal draws for every latent part.
    A pixel may land one 5-bit bin (8 levels) apart where the flow output
    sits on a bin edge; that must be rare."""
    jcfg, tcfg, _, jparams, tparams = _setup(param, learn_prior)
    key, salt, temp = jax.random.PRNGKey(7), 1, 0.7
    imgs_j = np.asarray(nft.make_sample_fn(jcfg, nft.NFTrainConfig(n_bits=5), IMG)(
        jparams, key, BATCH, temp, salt))
    noise = _jax_sample_noise(key, salt, jcfg, BATCH)
    sample = inference.make_sample_fn(tcfg, IMG, n_bits=5, device="cpu")
    imgs_t = sample(tparams, BATCH, temp, noise=noise).numpy()
    assert imgs_t.dtype == np.uint8 and imgs_t.shape == imgs_j.shape
    diff = np.abs(imgs_t.astype(int) - imgs_j.astype(int))
    assert diff.max() <= 8 and np.mean(diff > 0) < 0.01


@pytest.mark.parametrize("learn_prior", [True, False])
def test_sample_injected_noise_matches_jax_moments(learn_prior):
    """z_final = mean + e^{logsd}·T·eps with the JAX prior's moments; the
    split parts likewise, inside the JAX inverse."""
    jcfg, tcfg, _, jparams, tparams = _setup("plu", learn_prior)
    shapes = tglow.latent_shapes_nhwc(tcfg, IMG)
    noise = [np.random.default_rng(20 + i).standard_normal((BATCH, *s)).astype(np.float32)
             for i, s in enumerate(shapes)]
    temp = 0.8
    mean, logsd = jprior._moments(jparams["prior"], shapes[-1][-1])
    z_last = np.asarray(mean) + np.exp(np.asarray(logsd)) * temp * noise[-1]
    # the JAX inverse with the split part drawn from its prior by hand
    from nfdpm_tpu.ops import bijectors as jbj

    y = jnp.asarray(z_last)
    for sp in reversed(range(jcfg.steps)):
        y = jbj.step_inverse_pallas(jax.tree.map(lambda a: a[sp],
                                                 jparams["flow"]["final_steps"]), y)
    y = jbj.squeeze_inverse(y)
    block = jparams["flow"]["blocks"][0]
    m, ls = jbj._split_prior_moments(block["split"], y)
    y = jnp.concatenate([y, m + jnp.exp(ls) * temp * noise[0]], axis=-1)
    for sp in reversed(range(jcfg.steps)):
        y = jbj.step_inverse_pallas(jax.tree.map(lambda a: a[sp], block["steps"]), y)
    expected = np.asarray(jbj.squeeze_inverse(y))

    x_t = tglow.inverse(tparams["flow"], tcfg,
                        [tprior.gaussian_prior_sample(tparams["prior"], None,
                                                      (BATCH, *shapes[-1]), temp, t(noise[-1]))],
                        None, temp, [t(e) for e in noise])
    close(x_t, expected)


def test_generate_batched_chunks_and_seeds():
    _, tcfg, _, _, tparams = _setup("plu", True)
    sample = inference.make_sample_fn(tcfg, IMG, n_bits=5, device="cpu")
    a = inference.generate_batched(sample, tparams, 6, 4, 1.0, seed=3)
    b = inference.generate_batched(sample, tparams, 6, 4, 1.0, seed=3)
    c = inference.generate_batched(sample, tparams, 6, 4, 1.0, seed=4)
    assert a.shape == (6, IMG, IMG, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert not np.array_equal(a[:2], a[4:6])  # chunks draw fresh noise


def test_bits_per_dim_of_kernel_and_plain_routes_agree():
    """GlowConfig.use_kernels=False takes the plain step; both routes give
    the same bits/dim (on the CPU the wrappers' plain versions run)."""
    _, tcfg, _, _, tparams = _setup("plu", True)
    plain = dataclasses.replace(tcfg, use_kernels=False)
    noise = np.random.default_rng(1).uniform(size=(BATCH, IMG, IMG, 3)).astype(np.float32)
    a = inference.make_eval_step(tcfg, device="cpu")(tparams, t(_images()), noise=noise)
    b = inference.make_eval_step(plain, device="cpu")(tparams, t(_images()), noise=noise)
    close(a, b, atol=1e-5)


def test_unported_options_raise():
    # bf16 coupling CNNs are accepted (tests/test_torch_mixed_precision.py)
    assert tglow.GlowConfig(coupling_dtype="bfloat16").compute_dtype == torch.bfloat16
    with pytest.raises(ValueError):
        tglow.GlowConfig(invconv_param="lu")
