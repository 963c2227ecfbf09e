"""The unfused bijectors of nfdpm_tpu_torch/ops/bijectors.py (identity,
actnorm and the invertible 1x1 convolution, each forward and inverse) held
against nfdpm_tpu's on the CPU.

Inputs and parameters are made with numpy from a seed and fed to both
packages. Tolerances: elementwise atol 1e-5, and for the 1x1 convolution's
outputs rtol 1e-5 besides (test_torch_ops.py's folded weights: at 48
channels a perturbed PLU weight sums terms of up to about 1 that cancel to
outputs near 1, and fp32 sums in another order part by 1.1e-5);
log-determinants rtol 1e-5 / atol 1e-4; gradients rtol 1e-4 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, one_torch_thread, port_tree, randomize, t
from nfdpm_tpu.ops import bijectors as jbj
from nfdpm_tpu_torch.ops import bijectors as tbj


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


LDJ_TOL = dict(rtol=1e-5, atol=1e-4)
MIX_TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(2, 4, 4, 6), (3, 2, 5, 12), (1, 8, 8, 48)]


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _actnorm(c, seed):
    return randomize(jbj.init_actnorm(c), seed=seed, scale=0.3)


def _invconv(c, seed, param):
    init = jbj.init_invconv_full if param == "full" else jbj.init_invconv
    return randomize(init(seed, c), seed=seed + 1, scale=0.05)


@pytest.mark.parametrize("shape", SHAPES)
def test_identity_matches_jax(shape):
    x, ldj = _normal(1, shape), _normal(2, shape[:1], 10.0)
    y, got_ldj = tbj.identity_forward(t(x), t(ldj))
    want_y, want_ldj = jbj.identity_forward(jnp.asarray(x), jnp.asarray(ldj))
    close(y, want_y, atol=0)
    close(got_ldj, want_ldj, atol=0)
    close(tbj.identity_inverse(t(x)), jbj.identity_inverse(jnp.asarray(x)), atol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_actnorm_matches_jax(shape):
    params = _actnorm(shape[-1], seed=shape[-1])
    x, ldj = _normal(3, shape), _normal(4, shape[:1], 10.0)
    y, got_ldj = tbj.actnorm_forward(port_tree(params), t(x), t(ldj))
    want_y, want_ldj = jbj.actnorm_forward(params, jnp.asarray(x), jnp.asarray(ldj))
    close(y, want_y)
    close(got_ldj, want_ldj, **LDJ_TOL)
    close(tbj.actnorm_inverse(port_tree(params), t(x)),
          jbj.actnorm_inverse(params, jnp.asarray(x)))


@pytest.mark.parametrize("param", ["plu", "full"])
@pytest.mark.parametrize("shape", SHAPES)
def test_invconv_matches_jax(shape, param):
    params = _invconv(shape[-1], seed=5, param=param)
    x, ldj = _normal(6, shape), _normal(7, shape[:1], 10.0)
    y, got_ldj = tbj.invconv_forward(port_tree(params), t(x), t(ldj))
    want_y, want_ldj = jbj.invconv_forward(params, jnp.asarray(x), jnp.asarray(ldj))
    close(y, want_y, **MIX_TOL)
    close(got_ldj, want_ldj, **LDJ_TOL)
    close(tbj.invconv_inverse(port_tree(params), t(x)),
          jbj.invconv_inverse(params, jnp.asarray(x)), **MIX_TOL)


@pytest.mark.parametrize("param", ["plu", "full"])
@pytest.mark.parametrize("shape", SHAPES)
def test_inverse_undoes_forward(shape, param):
    an, ic = port_tree(_actnorm(shape[-1], 8)), port_tree(_invconv(shape[-1], 9, param))
    x, ldj = t(_normal(10, shape)), torch.zeros(shape[0])
    close(tbj.identity_inverse(tbj.identity_forward(x, ldj)[0]), x, atol=0)
    close(tbj.actnorm_inverse(an, tbj.actnorm_forward(an, x, ldj)[0]), x)
    close(tbj.invconv_inverse(ic, tbj.invconv_forward(ic, x, ldj)[0]), x, **MIX_TOL)


@pytest.mark.parametrize("param", ["plu", "full"])
@pytest.mark.parametrize("shape", SHAPES)
def test_actnorm_then_invconv_is_the_fused_pair(shape, param):
    an, ic = port_tree(_actnorm(shape[-1], 11)), port_tree(_invconv(shape[-1], 12, param))
    x, ldj = t(_normal(13, shape)), t(_normal(14, shape[:1], 10.0))
    y, got_ldj = tbj.invconv_forward(ic, *tbj.actnorm_forward(an, x, ldj))
    want_y, want_ldj = tbj.fused_actnorm_invconv_forward(an, ic, x, ldj)
    close(y, want_y, **MIX_TOL)
    close(got_ldj, want_ldj, **LDJ_TOL)
    x_back = tbj.actnorm_inverse(an, tbj.invconv_inverse(ic, y))
    close(x_back, tbj.fused_invconv_actnorm_inverse(an, ic, want_y), **MIX_TOL)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_invconv_gradients_match_jax_and_skip_the_fixed_factors(shape):
    """d/dparams of sum(g * y) + sum(ldj): the trained PLU leaves against
    jax.grad; p_mat and sign take none, as invconv_weight's stop_gradient
    gives them none in the JAX package."""
    params = _invconv(shape[-1], seed=15, param="plu")
    x, g = _normal(16, shape), _normal(17, shape)

    def jax_loss(p):
        y, ldj = jbj.invconv_forward(p, jnp.asarray(x), jnp.zeros(shape[0]))
        return jnp.sum(jnp.asarray(g) * y) + jnp.sum(ldj)

    want = jax.grad(jax_loss)(params)
    ported = port_tree(params)
    for leaf in ported.values():
        leaf.requires_grad_(True)
    y, ldj = tbj.invconv_forward(ported, t(x), torch.zeros(shape[0]))
    (torch.sum(t(g) * y) + torch.sum(ldj)).backward()
    for name in ("lower", "upper", "log_s"):
        close(ported[name].grad, want[name], atol=1e-6, rtol=1e-4)
    for name in ("p_mat", "sign"):
        assert ported[name].grad is None
        assert not np.asarray(want[name]).any()
