"""nfdpm_tpu_torch's ops held against nfdpm_tpu's on the CPU.

Each test makes its inputs with numpy from a seed and feeds the same numbers
to the JAX function and to its port. Where the JAX side has a Pallas
kernel, it runs in interpret mode, as tests/test_pallas_kernels.py runs it;
the port's wrappers take their plain versions on CPU tensors. Tolerances:
elementwise atol 1e-5, log-determinants rtol 1e-5 and atol 1e-4 (sums of
hundreds of fp32 terms, taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, port_tree, randomize, t
from nfdpm_tpu.models import prior as jprior
from nfdpm_tpu.ops import bijectors as jbj
from nfdpm_tpu.ops import coupling as jcoupling
from nfdpm_tpu.ops import quantize as jq
from nfdpm_tpu.ops import zeroconv as jzc
from nfdpm_tpu.ops.pallas import channel_mix as jcm
from nfdpm_tpu.ops.pallas import coupling_tail as jct
from nfdpm_tpu_torch.models import prior as tprior
from nfdpm_tpu_torch.ops import bijectors as tbj
from nfdpm_tpu_torch.ops import coupling as tcoupling
from nfdpm_tpu_torch.ops import quantize as tq
from nfdpm_tpu_torch.ops import zeroconv as tzc
from nfdpm_tpu_torch.ops.kernels import channel_mix as tcm
from nfdpm_tpu_torch.ops.kernels import coupling_tail as tct

LDJ_TOL = dict(rtol=1e-5, atol=1e-4)


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("n_bits", [5, 8])
def test_quantize_matches_jax(n_bits):
    rng = np.random.default_rng(n_bits)
    imgs = rng.integers(0, 256, (2, 4, 4, 3)).astype(np.float32) / 255.0
    noise = rng.uniform(size=imgs.shape).astype(np.float32)
    pre = tq.preprocess(t(imgs), n_bits)
    close(pre, jq.preprocess(jnp.asarray(imgs), n_bits), atol=0)
    # the trainer's injected-noise form of dequantize (nf_trainer.py:116-117)
    close(tq.dequantize(None, pre, n_bits, t(noise)),
          jq.preprocess(jnp.asarray(imgs), n_bits) + noise / jq.n_bins_of(n_bits))
    flow_out = rng.uniform(-0.6, 0.6, imgs.shape).astype(np.float32)
    post = tq.postprocess(t(flow_out), n_bits)
    assert post.dtype == torch.uint8
    np.testing.assert_array_equal(post.numpy(),
                                  np.asarray(jq.postprocess(jnp.asarray(flow_out), n_bits)))
    assert tq.n_bins_of(n_bits) == jq.n_bins_of(n_bits)


def test_dequantize_draws_from_generator():
    x = torch.zeros((2, 4, 4, 3))
    a = tq.dequantize(torch.Generator().manual_seed(3), x, 5)
    b = tq.dequantize(torch.Generator().manual_seed(3), x, 5)
    assert torch.equal(a, b)
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0 / 32


@pytest.mark.parametrize("k", [1, 3])
def test_zeroconv_matches_jax(k):
    params = randomize(jzc.init_zeroconv(6, 10, filter_size=k), seed=k, scale=0.2)
    x = _normal(10 + k, (2, 5, 5, 6))
    close(tzc.zeroconv_apply(port_tree(params), t(x)),
          jzc.zeroconv_apply(params, jnp.asarray(x)))


def test_coupling_net_matches_jax():
    params = randomize(jcoupling.init_coupling_net(np.random.default_rng(0), 4, 16, 8),
                       seed=1, scale=0.1)
    x = _normal(2, (2, 6, 6, 4))
    close(tcoupling.coupling_net_apply(port_tree(params), t(x)),
          jcoupling.coupling_net_apply(params, jnp.asarray(x)))


def test_coupling_net_init_matches_jax():
    jp = jcoupling.init_coupling_net(np.random.default_rng(5), 4, 16, 8)
    tp = tcoupling.init_coupling_net(np.random.default_rng(5), 4, 16, 8)
    for name in ("conv1", "conv2"):
        np.testing.assert_array_equal(tp[name]["w"], jp[name]["w"].transpose(3, 2, 0, 1))


@pytest.mark.parametrize("shape", [(2, 4, 4, 3), (1, 8, 2, 5)])
def test_squeeze_matches_jax(shape):
    x = _normal(0, shape)
    sq = tbj.squeeze_forward(t(x))
    close(sq, jbj.squeeze_forward(jnp.asarray(x)), atol=0)
    close(tbj.squeeze_inverse(sq), x, atol=0)
    close(tbj.squeeze_inverse(sq), jbj.squeeze_inverse(jbj.squeeze_forward(jnp.asarray(x))),
          atol=0)


@pytest.mark.parametrize("learn_prior", [True, False])
def test_split_and_gaussian_logp_match_jax(learn_prior):
    params = randomize(jbj.init_split(8, learn_prior), seed=3, scale=0.1)
    x = _normal(4, (2, 4, 4, 8))
    ldj = _normal(5, (2,))
    y_j, ldj_j, z_j, logp_j = jbj.split_forward(params, jnp.asarray(x), jnp.asarray(ldj),
                                                jnp.zeros((2,)))
    y_t, ldj_t, z_t, logp_t = tbj.split_forward(port_tree(params), t(x), t(ldj),
                                                torch.zeros(2))
    close(y_t, y_j, atol=0)
    close(z_t, z_j, atol=0)
    close(ldj_t, ldj_j, atol=0)
    close(logp_t, logp_j, **LDJ_TOL)
    _, _, _, none = tbj.split_forward(port_tree(params), t(x), t(ldj), None)
    assert none is None


def test_gaussian_logp_matches_jax():
    x, mean, logsd = (_normal(s, (3, 4, 4, 5)) for s in (0, 1, 2))
    close(tbj.gaussian_logp(t(x), t(mean), t(0.3 * logsd)),
          jbj.gaussian_logp(jnp.asarray(x), jnp.asarray(mean), jnp.asarray(0.3 * logsd)),
          **LDJ_TOL)


@pytest.mark.parametrize("learn_prior", [True, False])
def test_split_inverse_injected_noise_matches_jax_moments(learn_prior):
    """z = mean + e^{logsd}·T·eps with (mean, logsd) from the JAX split prior."""
    params = randomize(jbj.init_split(8, learn_prior), seed=6, scale=0.1)
    y, eps = _normal(7, (2, 4, 4, 4)), _normal(8, (2, 4, 4, 4))
    mean, logsd = jbj._split_prior_moments(params, jnp.asarray(y))
    z = np.asarray(mean) + np.exp(np.asarray(logsd)) * 0.7 * eps
    out = tbj.split_inverse(port_tree(params), t(y), None, None, 0.7, t(eps))
    close(out, np.concatenate([y, z], axis=-1))


@pytest.mark.parametrize("learn", [True, False])
def test_gaussian_prior_matches_jax(learn):
    params = randomize(jprior.init_gaussian_prior(12, learn), seed=9, scale=0.1)
    tparams = port_tree(params)
    x, eps = _normal(10, (2, 2, 2, 12)), _normal(11, (2, 2, 2, 12))
    close(tprior.gaussian_prior_logp(tparams, t(x)),
          jprior.gaussian_prior_logp(params, jnp.asarray(x)), **LDJ_TOL)
    mean, logsd = jprior._moments(params, 12)
    z = tprior.gaussian_prior_sample(tparams, None, (2, 2, 2, 12), 0.7, t(eps))
    close(z, np.asarray(mean) + np.exp(np.asarray(logsd)) * 0.7 * eps)
    ll = _normal(12, (4,))
    close(tprior.bits_per_dim(t(ll), 32.0, 48.0),
          jprior.bits_per_dim(jnp.asarray(ll), 32.0, 48.0))
    assert tprior.n_pixels(8, 1, True) == jprior.n_pixels(8, 1, True)
    assert tprior.n_pixels(8, 1, False) == jprior.n_pixels(8, 1, False)


def _invconv(param, c, seed):
    init = jbj.init_invconv_full if param == "full" else jbj.init_invconv
    return randomize(init(seed, c), seed=seed + 100, scale=0.05)


@pytest.mark.parametrize("param", ["plu", "full"])
def test_invconv_weights_match_jax(param):
    ic = _invconv(param, 8, 1)
    tic = port_tree(ic)
    close(tbj.invconv_weight(tic), jbj.invconv_weight(ic))
    close(tbj.invconv_inverse_weight(tic), jbj.invconv_inverse_weight(ic))
    close(tbj.invconv_logdet(tic), jbj.invconv_logdet(ic), **LDJ_TOL)
    eye = tbj.invconv_weight(tic) @ tbj.invconv_inverse_weight(tic)
    close(eye, np.eye(8), atol=1e-4)


@pytest.mark.parametrize("param", ["plu", "full"])
def test_invconv_init_matches_jax(param):
    init_j = jbj.init_invconv_full if param == "full" else jbj.init_invconv
    init_t = tbj.init_invconv_full if param == "full" else tbj.init_invconv
    jp, tp = init_j(4, 6), init_t(4, 6)
    assert jp.keys() == tp.keys()
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k])
    np.testing.assert_array_equal(tbj.plu_from_weight(torch.eye(3))["p_mat"],
                                  jbj.plu_from_weight(np.eye(3))["p_mat"])


@pytest.mark.parametrize("param", ["plu", "full"])
def test_fold_actnorm_invconv_matches_jax(param):
    an = randomize(jbj.init_actnorm(8), seed=2, scale=0.2)
    ic = _invconv(param, 8, 3)
    folded_t = tbj.fold_actnorm_invconv(port_tree(an), port_tree(ic))
    folded_j = jbj.fold_actnorm_invconv(an, ic)
    for a, b in zip(folded_t, folded_j):
        close(a, b, atol=1e-5, rtol=1e-5)
    x, ldj = _normal(4, (2, 3, 3, 8)), np.zeros(2, np.float32)
    y_t, ldj_t = tbj.fused_actnorm_invconv_forward(port_tree(an), port_tree(ic), t(x), t(ldj))
    y_j, ldj_j = jbj.fused_actnorm_invconv_forward(an, ic, jnp.asarray(x), jnp.asarray(ldj))
    close(y_t, y_j)
    close(ldj_t, ldj_j, **LDJ_TOL)
    close(tbj.fused_invconv_actnorm_inverse(port_tree(an), port_tree(ic), y_t), x, atol=1e-4)


@pytest.mark.parametrize("shape,o", [((2, 4, 4, 12), 12),   # square
                                     ((3, 5, 3, 12), 20),   # O > C, ragged N
                                     ((1, 4, 4, 48), 24)])  # O < C
def test_channel_mix_matches_pallas(shape, o):
    c = shape[-1]
    x, w, b = _normal(0, shape), _normal(1, (o, c), 0.3), _normal(2, (o,))
    before = tcm.channel_mix.launches
    out = tcm.channel_mix(t(x), t(w), t(b))
    assert tcm.channel_mix.launches == before  # CPU tensors: the plain version
    close(out, jcm.channel_mix(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), True))
    close(tcm.channel_mix_plain(t(x), t(w), t(b)), out, atol=0)


@pytest.mark.parametrize("shape", [(3, 4, 4, 6),    # D = 96
                                   (2, 5, 3, 7),    # D = 105, odd
                                   (9, 8, 8, 3)])   # D = 192, B > 8
def test_coupling_tail_matches_pallas(shape):
    ls, bias, xb = _normal(0, shape, 0.5), _normal(1, shape), _normal(2, shape)
    y_t, ldj_t = tct.coupling_tail(t(ls), t(bias), t(xb))
    y_j, ldj_j = jct.coupling_tail(jnp.asarray(ls), jnp.asarray(bias), jnp.asarray(xb), True)
    close(y_t, y_j)
    close(ldj_t, ldj_j, **LDJ_TOL)
    x_t = tct.coupling_tail_inverse(t(ls), t(bias), y_t)
    x_j = jct.coupling_tail_inverse(jnp.asarray(ls), jnp.asarray(bias), y_j, True)
    close(x_t, x_j)
    close(x_t, xb, atol=1e-4)


@pytest.mark.parametrize("fn,args", [
    (tcm.channel_mix, ((2, 4), (3, 4), (3,))),
    (tct.coupling_tail, ((2, 4), (2, 4), (2, 4))),
    (tct.coupling_tail_inverse, ((2, 4), (2, 4), (2, 4))),
])
def test_wrappers_refuse_non_cuda_devices(fn, args):
    """Only a CPU tensor takes the plain version; any other device must
    launch the kernel or raise, never fall back silently."""
    tensors = [torch.empty(s, device="meta") for s in args]
    with pytest.raises(ValueError, match="CUDA"):
        fn(*tensors)


def _step(param, c, seed, width=16):
    return randomize(jbj.init_step(seed, c, width, param), seed=seed + 50, scale=0.05)


@pytest.mark.parametrize("param", ["plu", "full"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_step_forward_matches_pallas(param, use_kernels):
    sp = _step(param, 12, 7)
    x, ldj = _normal(1, (2, 4, 4, 12)), _normal(2, (2,))
    y_j, ldj_j = jbj.step_forward_pallas(sp, jnp.asarray(x), jnp.asarray(ldj))
    y_t, ldj_t = tbj.step_forward(port_tree(sp), t(x), t(ldj), use_kernels)
    close(y_t, y_j)
    close(ldj_t, ldj_j, **LDJ_TOL)


@pytest.mark.parametrize("param", ["plu", "full"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_step_inverse_matches_pallas(param, use_kernels):
    sp = _step(param, 12, 8)
    y = _normal(3, (2, 4, 4, 12))
    x_j = jbj.step_inverse_pallas(sp, jnp.asarray(y))
    x_t = tbj.step_inverse(port_tree(sp), t(y), use_kernels)
    close(x_t, x_j)
    y_back, _ = tbj.step_forward(port_tree(sp), x_t, torch.zeros(2), use_kernels)
    close(y_back, y, atol=1e-4)


def test_step_init_matches_jax():
    jp, tp = jbj.init_step(11, 12, 16, "plu"), tbj.init_step(11, 12, 16, "plu")
    np.testing.assert_array_equal(port_tree(jp)["coupling"]["net"]["conv1"]["w"].numpy(),
                                  tp["coupling"]["net"]["conv1"]["w"])
    np.testing.assert_array_equal(tp["invconv"]["lower"], jp["invconv"]["lower"])
    assert jax.tree.structure(jax.tree.map(np.asarray, jp)) == jax.tree.structure(tp)
