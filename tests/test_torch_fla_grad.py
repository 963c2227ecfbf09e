"""The gradient of fused_linear_attention in nfdpm_tpu_torch against nfdpm_tpu
on the CPU.

`fused_linear_attention_bwd_plain` writes the chain rule out term by term,
the formulas the CUDA backward kernel implements; it is held against
`jax.vjp` of `_reference_impl`, the function whose VJP the JAX package's
custom VJP (`_fla_bwd`) takes, at several token counts, widths and
batches. The autograd Function on CPU tensors (plain forward and plain
backward) is held against `jax.grad` of the JAX kernel in interpret mode.
The kernel itself is held against the plain version on the card
(tests/test_torch_kernels_cuda.py). Tolerances: atol 1e-5 for dx; the
weight, bias and gain gradients are sums over up to B*N = 192 rows of
terms up to about 400 in size, which cancel (XLA sums them in another
order), so they are held to 1e-5 of the gradient's largest entry
(measured: 3.4e-5 on a db_out whose largest entry is 234).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, one_torch_thread, t
from nfdpm_tpu.ops.pallas import fused_linear_attention as jfla
from nfdpm_tpu_torch.ops.kernels import fused_linear_attention as fla

NAMES = ("dx", "dW_qkv", "dW_out", "db_out", "dg")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _operands(seed, b, h, w, c):
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)
    return (f32(rng.standard_normal((b, h, w, c))),
            f32(rng.standard_normal((c, 384)) * c ** -0.5),
            f32(rng.standard_normal((128, c)) * 128 ** -0.5),
            f32(0.1 * rng.standard_normal(c)),
            f32(1.0 + 0.1 * rng.standard_normal(c)),
            f32(rng.standard_normal((b, h, w, c))))


def _assert_grads(got, want):
    for name, a, e in zip(NAMES, got, want):
        e = np.asarray(e)
        atol = 1e-5 if name == "dx" else 1e-5 * float(np.abs(e).max())
        close(a, e, atol=atol)


@jax.jit
def _jax_vjp(x, wq, wo, bo, g, dout):
    _, vjp = jax.vjp(lambda *a: jfla._reference_impl(*a, heads=4, dim_head=32),
                     x, wq, wo, bo, g)
    return vjp(dout)


# N = 4, 16, 64 tokens; C = 12, 48, 64, 128; B = 1 and 3
@pytest.mark.parametrize("shape", [(1, 2, 2, 12), (3, 4, 4, 48), (3, 8, 8, 64),
                                   (1, 4, 4, 128)])
def test_bwd_plain_matches_jax_vjp(shape):
    x, wq, wo, bo, g, dout = _operands(sum(shape), *shape)
    want = _jax_vjp(*map(jnp.asarray, (x, wq, wo, bo, g, dout)))
    got = fla.fused_linear_attention_bwd_plain(*map(t, (x, wq, wo, bo, g, dout)))
    for a, e in zip(got, want):
        assert tuple(a.shape) == tuple(e.shape)
    _assert_grads(got, want)


def test_function_on_cpu_matches_jax_grad_of_the_kernel():
    """The wrapper under grad goes through FusedLinearAttentionFunction; its
    gradients of a scalar loss equal jax.grad through the Pallas kernel
    (interpret mode), whose custom VJP is _fla_bwd."""
    x, wq, wo, bo, g, dout = _operands(3, 2, 4, 4, 64)

    def jloss(*a):
        return jnp.sum(jfla.fused_linear_attention(*a, 4, 32, True) * dout)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (x, wq, wo, bo, g)))
    leaves = [t(a).requires_grad_(True) for a in (x, wq, wo, bo, g)]
    y = fla.fused_linear_attention(*leaves)
    assert type(y.grad_fn).__name__ == "FusedLinearAttentionFunctionBackward"
    got = torch.autograd.grad((y * t(dout)).sum(), leaves)
    _assert_grads(got, want)


def test_function_skips_what_is_not_needed_and_takes_views():
    x, wq, wo, bo, g, dout = _operands(4, 2, 2, 4, 12)
    want = fla.fused_linear_attention_bwd_plain(*map(t, (x, wq, wo, bo, g, dout)))
    wq_leaf = t(wq).requires_grad_(True)
    y = fla.fused_linear_attention(t(x), wq_leaf, t(wo), t(bo), t(g))
    # the cotangent as autograd may hand it over: a slice of something wider
    wide = torch.cat([t(dout), t(dout)], dim=-1)[..., :12]
    assert not wide.is_contiguous()
    (d_wq,) = torch.autograd.grad(y, (wq_leaf,), wide)
    close(d_wq, want[1].numpy(), atol=1e-5, rtol=1e-5)
    # no grad wanted: no graph, the plain forward's values
    with torch.no_grad():
        y2 = fla.fused_linear_attention(t(x), wq_leaf, t(wo), t(bo), t(g))
    assert y2.grad_fn is None and torch.equal(y2, y.detach())

