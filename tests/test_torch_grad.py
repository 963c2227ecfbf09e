"""Gradients, data-dependent init and remat of nfdpm_tpu_torch against
nfdpm_tpu on the CPU.

Small sizes (Glow L2/K2, coupling width 32, 8x8x3, batch 8). The JAX side
runs its Pallas route in interpret mode, so its custom VJPs are the ones
differentiated; the port runs its kernel route, whose autograd Functions
take the plain versions of their kernels, forward and backward, on CPU
tensors. Tolerances: kernel-level gradients atol 1e-5 (fp32, sums of at most
a few hundred terms in another order); ddinit atol 1e-5; gradients of the
bits/dim loss rtol 1e-4 and atol 1e-6, leaf by leaf.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, one_torch_thread, port_tree, randomize, t, to_numpy_tree
from nfdpm_tpu.models import glow as jglow
from nfdpm_tpu.models import prior as jprior
from nfdpm_tpu.ops import bijectors as jbj
from nfdpm_tpu.ops import coupling as jcoupling
from nfdpm_tpu.ops import quantize as jq
from nfdpm_tpu.ops.pallas import channel_mix as jcm
from nfdpm_tpu.ops.pallas import coupling_tail as jct
from nfdpm_tpu_torch import convert
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.ops import bijectors as tbj
from nfdpm_tpu_torch.ops import coupling as tcoupling
from nfdpm_tpu_torch.ops.kernels import channel_mix as cm
from nfdpm_tpu_torch.ops.kernels import coupling_tail as ct
from nfdpm_tpu_torch.ops.kernels import fused_linear_attention as fla
from nfdpm_tpu_torch.training import nf_trainer as tnft

IMG, BATCH, N_BITS = 8, 8, 5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _rng_arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# The two kernels' gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 4, 4, 6), (5, 3, 2, 7), (1, 1, 1, 1)])
def test_coupling_tail_bwd_plain_matches_jax_vjp(shape):
    ls, b, xb, g_y = _rng_arrays(0, shape, shape, shape, shape)
    (g_ldj,) = _rng_arrays(1, shape[:1])
    _, vjp = jax.vjp(lambda *a: jct.coupling_tail(*a, True), *map(jnp.asarray, (ls, b, xb)))
    d_ls_j, d_b_j, d_xb_j = vjp((jnp.asarray(g_y), jnp.asarray(g_ldj)))
    d_ls, d_xb = ct.coupling_tail_bwd_plain(t(ls), t(b), t(xb), t(g_y), t(g_ldj))
    close(d_ls, d_ls_j, atol=1e-5)
    close(d_xb, d_xb_j, atol=1e-5)
    close(d_xb, d_b_j, atol=1e-5)
    # a cotangent left out counts as zeros
    only_y = ct.coupling_tail_bwd_plain(t(ls), t(b), t(xb), t(g_y), None)
    only_ldj = ct.coupling_tail_bwd_plain(t(ls), t(b), t(xb), None, t(g_ldj))
    close(only_y[0] + only_ldj[0], d_ls_j, atol=1e-5)
    close(only_y[1], d_xb_j, atol=1e-5)
    assert not only_ldj[1].any()


@pytest.mark.parametrize("given", ["both", "g_y", "g_ldj"])
def test_coupling_tail_function_matches_autograd_of_plain(given):
    shape = (8, 4, 4, 6)
    arrays = _rng_arrays(2, shape, shape, shape, shape)
    leaves = [t(a).requires_grad_(True) for a in arrays[:3]]
    g_y, g_ldj = t(arrays[3]), t(_rng_arrays(3, shape[:1])[0])
    y, ldj = ct.coupling_tail(*leaves)
    assert y.grad_fn is not None and ldj.grad_fn is not None
    y_p, ldj_p = ct.coupling_tail_plain(*leaves)
    assert torch.equal(y, y_p) and torch.equal(ldj, ldj_p)
    outs = {"both": ((y, ldj), (g_y, g_ldj)), "g_y": ((y,), (g_y,)),
            "g_ldj": ((ldj,), (g_ldj,))}[given]
    outs_p = {"both": (y_p, ldj_p), "g_y": (y_p,), "g_ldj": (ldj_p,)}[given]
    got = torch.autograd.grad(outs[0], leaves, outs[1])
    want = torch.autograd.grad(outs_p, leaves, outs[1], allow_unused=True)
    for a, b in zip(got, want):
        close(a, np.zeros(shape, np.float32) if b is None else b.numpy(), atol=1e-6)


@pytest.mark.parametrize("shape,o", [((8, 4, 4, 12), 12), ((5, 3, 2, 7), 10)])
def test_channel_mix_function_matches_jax_vjp(shape, o):
    x, g = _rng_arrays(4, shape, shape[:-1] + (o,))
    w, b = _rng_arrays(5, (o, shape[-1]), (o,), scale=0.3)
    y_j, vjp = jax.vjp(lambda *a: jcm.channel_mix(*a, True), *map(jnp.asarray, (x, w, b)))
    dx_j, dw_j, db_j = vjp(jnp.asarray(g))
    leaves = [t(a).requires_grad_(True) for a in (x, w, b)]
    y = cm.ChannelMixFunction.apply(*leaves)
    close(y, y_j, atol=1e-5)
    # the cotangent as autograd hands it over: a slice of something wider
    wide = torch.cat([t(g), t(g)], dim=-1)[..., :o]
    assert not wide.is_contiguous()
    dx, dw, db = torch.autograd.grad(y, leaves, wide)
    close(dx, dx_j, atol=1e-5)
    close(dw, dw_j, atol=1e-5)
    close(db, db_j, atol=1e-5)
    # the wrapper goes through the Function whenever a gradient is wanted
    y2 = cm.channel_mix(*leaves)
    assert type(y2.grad_fn).__name__ == "ChannelMixFunctionBackward"
    only_w = torch.autograd.grad(cm.channel_mix(t(x), leaves[1], t(b)), leaves[1], t(g))[0]
    close(only_w, dw_j, atol=1e-5)
    with torch.no_grad():
        assert cm.channel_mix(*leaves).grad_fn is None


def test_wrappers_without_a_gradient_raise_under_grad():
    x = t(_rng_arrays(6, (2, 4, 4, 16))[0])
    w_qkv, w_out, v = (t(a) for a in _rng_arrays(7, (16, 384), (128, 16), (16,)))
    for leaf in (x, v):
        leaf.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient.*the inverse tail"):
        ct.coupling_tail_inverse(x, x, x)
    # fused_linear_attention has its gradient now (test_torch_fla_grad.py)
    y = fla.fused_linear_attention(x.detach(), w_qkv, w_out, v, v)
    assert type(y.grad_fn).__name__ == "FusedLinearAttentionFunctionBackward"
    # the plain versions stay differentiable; without grad the wrappers run
    assert ct.coupling_tail_inverse_plain(x, x, x).grad_fn is not None
    assert fla.fused_linear_attention_plain(x, w_qkv, w_out, v, v).grad_fn is not None
    with torch.no_grad():
        assert ct.coupling_tail_inverse(x, x, x).shape == x.shape
    with torch.inference_mode():
        assert fla.fused_linear_attention(x, w_qkv, w_out, v, v).shape == x.shape


# ---------------------------------------------------------------------------
# ddinit
# ---------------------------------------------------------------------------

def _assert_tree_close(actual, expected, atol, rtol=0.0):
    """`actual` (the port's layout, tensors) against `expected` (the same
    layout, numpy), leaf by leaf; returns the number of leaves compared."""
    got = dict(convert.named_leaves(actual))
    want = dict(convert.named_leaves(expected))
    assert got.keys() == want.keys()
    for name in got:
        np.testing.assert_allclose(got[name].detach().numpy(), want[name], atol=atol,
                                   rtol=rtol, err_msg=name)
    return len(got)


def test_coupling_net_ddinit_matches_jax():
    net = randomize(to_numpy_tree(jcoupling.init_coupling_net(
        np.random.default_rng(0), 6, 32, 12)), seed=1)
    (x,) = _rng_arrays(8, (BATCH, 4, 4, 6))
    new_j, out_j = jcoupling.coupling_net_ddinit(jax.tree.map(jnp.asarray, net), jnp.asarray(x))
    tnet = port_tree(net)
    new_t, out_t = tcoupling.coupling_net_ddinit(tnet, t(x))
    close(out_t, out_j, atol=1e-5)
    assert _assert_tree_close(new_t, port_tree(new_j), atol=1e-5) == 9
    assert new_t["an1"]["scale"] is not tnet["an1"]["scale"]  # new leaves, no mutation
    assert not tnet["an1"]["scale"].equal(new_t["an1"]["scale"])
    assert new_t["conv1"]["w"] is tnet["conv1"]["w"]


@pytest.mark.parametrize("param", ["plu", "full"])
def test_step_ddinit_matches_jax(param):
    step = randomize(to_numpy_tree(jbj.init_step(0, 12, 32, param)), seed=2)
    (x,) = _rng_arrays(9, (BATCH, 4, 4, 12))
    x = 0.3 + 2.0 * x
    new_j, y_j = jbj.step_ddinit(jax.tree.map(jnp.asarray, step), jnp.asarray(x))
    new_t, y_t = tbj.step_ddinit(port_tree(step), t(x))
    close(y_t, y_j, atol=1e-5)
    _assert_tree_close(new_t, port_tree(new_j), atol=1e-5)
    an, y_an = tbj.actnorm_ddinit(t(x))
    # Bessel-corrected: unit variance with ddof = 1, zero mean
    close(y_an.mean(dim=(0, 1, 2)), np.zeros(12), atol=1e-5)
    close(y_an.std(dim=(0, 1, 2)), np.ones(12), atol=1e-4)
    close(an["bias"], -x.mean(axis=(0, 1, 2)), atol=1e-6)


def _glow_pair(param, learn_prior=True, seed=0, remat=False):
    kw = dict(in_channels=3, levels=2, steps=2, coupling_width=32,
              learn_prior=learn_prior, invconv_param=param)
    jcfg = jglow.GlowConfig(use_pallas=True, **kw)
    tcfg = tglow.GlowConfig(use_kernels=True, remat=remat, **kw)
    flow = jglow.init_glow(seed, jcfg)
    prior = jprior.init_gaussian_prior(tglow.final_channels(tcfg), learn_prior)
    tree = randomize(to_numpy_tree({"flow": flow, "prior": prior}), seed=seed + 1)
    return jcfg, tcfg, tree


def _images(seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (BATCH, IMG, IMG, 3)).astype(np.float32) / 255.0


@pytest.mark.parametrize("param", ["plu", "full"])
def test_glow_ddinit_matches_jax(param):
    jcfg, tcfg, tree = _glow_pair(param)
    x = (np.floor(_images() * 255 / 8) / 32 - 0.5
         + np.random.default_rng(4).random((BATCH, IMG, IMG, 3)) / 32).astype(np.float32)
    new_j = jglow.ddinit(jax.tree.map(jnp.asarray, tree["flow"]), jcfg, jnp.asarray(x))
    tflow = convert.from_jax_params(tree, "cpu")["flow"]
    new_t = tglow.ddinit(tflow, tcfg, t(x))
    expected = convert.from_jax_params({"flow": to_numpy_tree(new_j), "prior": {}}, "cpu")
    _assert_tree_close(new_t, convert._map_leaves(expected["flow"], lambda a: a.numpy()),
                       atol=1e-5)
    # what ddinit does not re-initialize is shared, and the input tree is as it was
    assert new_t["blocks"][0]["split"] is tflow["blocks"][0]["split"]
    step_new, step_old = new_t["final_steps"][1], tflow["final_steps"][1]
    assert step_new["invconv"] is step_old["invconv"]
    assert not step_new["actnorm"]["scale"].equal(step_old["actnorm"]["scale"])
    close(step_old["actnorm"]["scale"],
          np.asarray(tree["flow"]["final_steps"]["actnorm"]["scale"])[1], atol=0)


# ---------------------------------------------------------------------------
# The loss's gradient, every leaf
# ---------------------------------------------------------------------------

def _jax_loss(jcfg, params, batch, noise):
    """The loss_fn of nfdpm_tpu.training.nf_trainer.make_train_step with
    inject_noise=True (it is a closure there)."""
    n_bins = jq.n_bins_of(N_BITS)
    x = jq.preprocess(batch, N_BITS) + noise / n_bins
    latents, ldj, logp = jglow.forward(params["flow"], jcfg, x)
    ll = ldj + logp + jprior.gaussian_prior_logp(params["prior"], latents[-1])
    return jprior.bits_per_dim(ll, n_bins, jprior.n_pixels(IMG, 3, True))


@pytest.mark.parametrize("param,learn_prior", [("plu", True), ("full", True), ("plu", False)])
def test_loss_gradient_matches_jax_grad_leaf_by_leaf(param, learn_prior):
    jcfg, tcfg, tree = _glow_pair(param, learn_prior)
    batch = _images()
    noise = np.random.default_rng(5).random(batch.shape).astype(np.float32)
    bpd_j, grads_j = jax.value_and_grad(lambda p: _jax_loss(
        jcfg, p, jnp.asarray(batch), jnp.asarray(noise)))(jax.tree.map(jnp.asarray, tree))

    params = convert.trainable(convert.from_jax_params(tree, "cpu"))
    loss_fn = tnft.make_loss_fn(tcfg, tnft.NFTrainConfig(n_bits=N_BITS))
    bpd_t, _ = loss_fn(params, t(batch), noise=t(noise))
    bpd_t.backward()
    assert abs(float(bpd_t.detach()) - float(bpd_j)) < 1e-5
    expected = convert.from_jax_params(to_numpy_tree(grads_j), "cpu")
    want = dict(convert.named_leaves(expected))
    n = 0
    for name, leaf in convert.named_leaves(params):
        if convert.is_frozen_path(name):
            assert leaf.grad is None and not leaf.requires_grad
            continue
        assert leaf.grad is not None, name
        np.testing.assert_allclose(leaf.grad.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
        assert leaf.grad.abs().max() > 0, name
        n += 1
    assert n == len(want) - (8 if param == "plu" else 0)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_remat_equals_no_remat_bit_for_bit(use_kernels):
    _, tcfg, tree = _glow_pair("plu")
    batch, noise = t(_images()), t(np.random.default_rng(6).random((BATCH, IMG, IMG, 3)))
    outs = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat, use_kernels=use_kernels)
        params = convert.trainable(convert.from_jax_params(tree, "cpu"))
        bpd, ll = tnft.make_loss_fn(cfg, tnft.NFTrainConfig())(params, batch, noise=noise)
        bpd.backward()
        outs.append((bpd.detach(), ll.detach(),
                     [p.grad for _, p in convert.named_leaves(params) if p.requires_grad]))
    (bpd_a, ll_a, grads_a), (bpd_b, ll_b, grads_b) = outs
    assert torch.equal(bpd_a, bpd_b) and torch.equal(ll_a, ll_b)
    assert len(grads_a) == len(grads_b) > 50
    for a, b in zip(grads_a, grads_b):
        assert torch.equal(a, b)


def test_glow_config_accepts_scan_unroll_and_refuses_bf16():
    """scan_unroll is accepted and ignored; bf16, once refused, is accepted
    now (its tests: tests/test_torch_mixed_precision.py)."""
    assert tglow.GlowConfig(scan_unroll=4) == dataclasses.replace(
        tglow.GlowConfig(), scan_unroll=4)
    bf16 = tglow.GlowConfig(coupling_dtype="bfloat16", remat=True)
    assert bf16.compute_dtype == torch.bfloat16 and bf16.remat
