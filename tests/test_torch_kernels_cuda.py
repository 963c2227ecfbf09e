"""The CUDA kernels of nfdpm_tpu_torch against their plain PyTorch versions.

These tests need a CUDA card (and nvcc to build the kernels); elsewhere they
skip. On the card, run them without the JAX test bootstrap:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: elementwise rtol 1e-5 and atol 1e-5 (channel_mix forward and
dx mode too); the coupling logdet, a sum
of up to D log terms taken in another order, rtol 1e-5 and atol 1e-4; the
linear-attention block, whose LayerNorm divides sums of up to C + 128 + N
products taken in another order by the row's spread, rtol 1e-4 and atol 1e-4
(its projections run in 3xTF32 on the tensor cores: products to about
2^-19 relative); its contexts rtol and atol 1e-4, the k softmax's maxima 1e-5 and
sums rtol and atol 1e-4 (sums of up to N exponentials).
Gradients: dW and db sum over up to N = 16384 rows (rtol 1e-4, atol 1e-4),
and so do the step tail's d_zb and d_zlogs;
the linear-attention block's dx rtol and atol 1e-4, its weight, bias and
gain gradients within 1e-5 of each gradient's largest entry. The whole-step
megakernel: y rtol and atol 1e-5, its logdet (a sum of H W C/2 log terms,
each from sums of up to 9 x 512 products) rtol 1e-5 and atol 1e-3, the
bounds of the JAX package's own test of the TPU kernel.
"""

import pytest
import torch

import nfdpm_tpu_torch
from nfdpm_tpu_torch.ops.kernels import channel_mix as cm
from nfdpm_tpu_torch.ops.kernels import coupling_tail as ct
from nfdpm_tpu_torch.ops.kernels import fused_linear_attention as fla
from nfdpm_tpu_torch.ops.kernels import step_megakernel as sm

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen, device="cuda") * scale


# the three level shapes of the served Glow (the square kernel), a ragged
# C != O and a wide one (the generic kernel)
CM_SHAPES = [((64, 16, 16, 12), 12), ((64, 8, 8, 24), 24), ((64, 4, 4, 48), 48),
             ((37, 3, 5, 14), 20), ((3, 1, 1, 192), 192)]


@pytest.mark.parametrize("shape,o", CM_SHAPES)
def test_channel_mix_matches_plain(gen, shape, o):
    x, w, b = _randn(gen, *shape), _randn(gen, o, shape[-1], scale=0.3), _randn(gen, o)
    before = cm.channel_mix.launches
    y = cm.channel_mix(x, w, b)
    torch.cuda.synchronize()
    assert cm.channel_mix.launches == before + 1
    torch.testing.assert_close(y, cm.channel_mix_plain(x, w, b), rtol=1e-5, atol=1e-5)
    # an operand off 16-byte alignment takes the generic kernel: same values
    x_off = torch.empty(x.numel() + 1, device="cuda")[1:].view(x.shape).copy_(x)
    torch.testing.assert_close(cm.channel_mix(x_off, w, b), y, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,o", CM_SHAPES)
def test_channel_mix_dx_matches_plain(gen, shape, o):
    """The dx mode, g [..., O] W [O, C]: one launch, no W^T copy, no bias."""
    g, w = _randn(gen, *shape[:-1], o), _randn(gen, o, shape[-1], scale=0.3)
    before = cm.channel_mix.launches
    dx = cm.channel_mix_dx(g, w)
    torch.cuda.synchronize()
    assert cm.channel_mix.launches == before + 1
    assert dx.shape == shape
    torch.testing.assert_close(dx, cm.channel_mix_dx_plain(g, w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(64, 16, 16, 6), (37, 3, 5, 7), (1, 1, 1, 1)])
def test_coupling_tail_and_inverse_match_plain(gen, shape):
    ls, b, xb = _randn(gen, *shape, scale=0.5), _randn(gen, *shape), _randn(gen, *shape)
    y, ldj = ct.coupling_tail(ls, b, xb)
    y_p, ldj_p = ct.coupling_tail_plain(ls, b, xb)
    torch.testing.assert_close(y, y_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ldj, ldj_p, rtol=1e-5, atol=1e-4)
    again = ct.coupling_tail(ls, b, xb)[1]
    assert torch.equal(ldj, again)  # fixed reduction order, no atomics
    x = ct.coupling_tail_inverse(ls, b, y)
    torch.testing.assert_close(x, ct.coupling_tail_inverse_plain(ls, b, y),
                               rtol=1e-5, atol=1e-5)


# The linear-attention calls of one evaluation of the three UNets of
# configs/nf_diffusion.yaml (parts 16x16, 8x8, 4x4; per part at side H:
# (H, 64), (H/2, 64), (H/2, 128), (H, 64)) as (side, C).
UNET_CALLS = [(s, c) for h in (16, 8, 4) for s, c in ((h, 64), (h // 2, 64), (h // 2, 128),
                                                       (h, 64))]
# Each distinct call at batch 64 (sampling and training) and 32 (VLB
# scoring); ragged N on both sides of the fused plan's 64 tokens at C = 20;
# a ragged C, one token, and C past one staged chunk of the out-projection.
FLA_SHAPES = ([(64, s, s, c) for s, c in sorted(set(UNET_CALLS))]
              + [(32, s, s, c) for s, c in sorted(set(UNET_CALLS))]
              + [(5, 3, 5, 20), (5, 7, 9, 20), (5, 1, 65, 20), (5, 1, 257, 20),
                 (3, 1, 1, 7), (2, 4, 4, 200)])


def _attention_case(gen, shape):
    c = shape[-1]
    x = _randn(gen, *shape)
    w_qkv, w_out = _randn(gen, c, 384, scale=c ** -0.5), _randn(gen, 128, c, scale=128 ** -0.5)
    b_out, g = _randn(gen, c, scale=0.1), 1.0 + _randn(gen, c, scale=0.1)
    return x, w_qkv, w_out, b_out, g


@pytest.mark.parametrize("shape", FLA_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fused_linear_attention_matches_plain(gen, shape):
    args = _attention_case(gen, shape)
    before = fla.fused_linear_attention.launches
    y = fla.fused_linear_attention(*args)
    torch.cuda.synchronize()
    assert fla.fused_linear_attention.launches == before + 1
    torch.testing.assert_close(y, fla.fused_linear_attention_plain(*args),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(y, fla.fused_linear_attention(*args))


@pytest.mark.parametrize("shape", FLA_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fused_linear_attention_writes_contexts_and_softmax_stats(gen, shape):
    """ctx [B, 4, 32, 32] and stats [B, 4, 2, 32] (each k column's softmax
    maximum and sum over the tokens), as the backward kernel reads them,
    against the same quantities formed in PyTorch; the same bits twice."""
    x, w_qkv, w_out, b_out, g = _attention_case(gen, shape)
    b, hh, ww, c = shape
    n = hh * ww
    y, ctx, stats = fla._forward_kernel(x, w_qkv, w_out, b_out, g)
    _, k, v = torch.matmul(x.reshape(b, n, c), w_qkv).split(128, dim=-1)
    k, v = k.reshape(b, n, 4, 32), v.reshape(b, n, 4, 32)
    m = k.amax(dim=1)
    s = torch.exp(k - m[:, None]).sum(dim=1)
    want_ctx = torch.einsum("bnhd,bnhe->bhde", torch.softmax(k, dim=1), v / n)
    torch.testing.assert_close(stats[:, :, 0], m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(stats[:, :, 1], s, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ctx, want_ctx, rtol=1e-4, atol=1e-4)
    again = fla._forward_kernel(x, w_qkv, w_out, b_out, g)
    assert all(torch.equal(a, e) for a, e in zip((y, ctx, stats), again))


@pytest.mark.parametrize("shape", FLA_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_attention_plan_smem_matches_the_kernel(gen, shape):
    """The shared memory the wrapper's plan is checked with is what the
    kernel lays out for it."""
    b, hh, ww, c = shape
    p = fla.plan(hh * ww, c)
    kernel_smem = fla._build.function("attention_kernels", "fused_linear_attention_plan_smem")
    assert fla.smem_bytes(p.fused, p.m_tiles, c) == kernel_smem(int(p.fused), p.m_tiles, c)


# the three level shapes of the L3 flow at batch 64, and a ragged case
@pytest.mark.parametrize("shape", [(64, 16, 16, 6), (64, 8, 8, 12), (64, 4, 4, 24),
                                   (37, 3, 5, 7)])
@pytest.mark.parametrize("given", ["both", "g_y", "g_ldj"])
def test_coupling_tail_bwd_matches_plain(gen, shape, given):
    ls, b, xb = _randn(gen, *shape, scale=0.5), _randn(gen, *shape), _randn(gen, *shape)
    g_y = _randn(gen, *shape) if given != "g_ldj" else None
    g_ldj = _randn(gen, shape[0]) if given != "g_y" else None
    before = ct.coupling_tail_bwd.launches
    d_ls, d_xb = ct.coupling_tail_bwd(ls, b, xb, g_y, g_ldj)
    torch.cuda.synchronize()
    assert ct.coupling_tail_bwd.launches == before + 1
    d_ls_p, d_xb_p = ct.coupling_tail_bwd_plain(ls, b, xb, g_y, g_ldj)
    torch.testing.assert_close(d_ls, d_ls_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(d_xb, d_xb_p, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(64, 16, 16, 6), (64, 4, 4, 24), (37, 3, 5, 7)])
def test_coupling_tail_gradient_matches_autograd_of_plain(gen, shape):
    leaves = [(_randn(gen, *shape, scale=s)).requires_grad_(True) for s in (0.5, 1.0, 1.0)]
    g_y, g_ldj = _randn(gen, *shape), _randn(gen, shape[0])
    y, ldj = ct.coupling_tail(*leaves)
    assert y.grad_fn is not None and ldj.grad_fn is not None
    # cotangents as autograd hands them over: a slice and an expanded scalar
    wide = torch.cat([g_y, g_y], dim=-1)[..., : shape[-1]]
    fwd, bwd = ct.coupling_tail.launches, ct.coupling_tail_bwd.launches
    got = torch.autograd.grad((y, ldj), leaves, (wide, g_ldj[:1].expand(shape[0])))
    assert (ct.coupling_tail.launches, ct.coupling_tail_bwd.launches) == (fwd, bwd + 1)
    want = torch.autograd.grad(ct.coupling_tail_plain(*leaves), leaves,
                               (g_y, g_ldj[:1].expand(shape[0])))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # only one output used: the other's cotangent is None
    only_ldj = torch.autograd.grad(ct.coupling_tail(*leaves)[1].sum(), leaves)
    want_ldj = torch.autograd.grad(ct.coupling_tail_plain(*leaves)[1].sum(), leaves,
                                   allow_unused=True)
    torch.testing.assert_close(only_ldj[0], want_ldj[0], rtol=1e-5, atol=1e-5)
    assert not only_ldj[1].any() and not only_ldj[2].any()


# the three level shapes of the L3 flow at batch 64 (C/2 = 6 takes 8-byte
# accesses, 12 and 24 16-byte ones), a ragged case (C/2 = 5: 4-byte), a
# single pixel and the smallest C
STEP_SHAPES = [(64, 16, 16, 12), (64, 8, 8, 24), (64, 4, 4, 48), (5, 3, 5, 10),
               (37, 1, 1, 48), (3, 2, 2, 2)]


def _step_case(gen, shape):
    c = shape[-1]
    return (_randn(gen, *shape), _randn(gen, *shape, scale=0.5), _randn(gen, c, scale=0.2),
            _randn(gen, c, scale=0.2), _randn(gen, shape[0], scale=10.0))


def _misaligned(t):
    """The same values 4 bytes off the allocation's 16-byte alignment."""
    return torch.empty(t.numel() + 1, device=t.device)[1:].view(t.shape).copy_(t)


@pytest.mark.parametrize("shape", STEP_SHAPES)
def test_coupling_step_tail_matches_plain(gen, shape):
    args = _step_case(gen, shape)
    before = ct.coupling_tail.launches
    out, ldj = ct.coupling_step_tail(*args)
    torch.cuda.synchronize()
    assert ct.coupling_tail.launches == before + 1
    out_p, ldj_p = ct.coupling_step_tail_plain(*args)
    torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ldj, ldj_p, rtol=1e-5, atol=1e-4)
    # the first half passes through untouched
    assert torch.equal(out[..., : shape[-1] // 2], args[0][..., : shape[-1] // 2])
    # fixed reduction order, no atomics on values: the same bits again
    again = ct.coupling_step_tail(*args)
    assert torch.equal(out, again[0]) and torch.equal(ldj, again[1])
    # operands off 16-byte alignment take a narrower access: same values
    y_off, r_off = _misaligned(args[0]), _misaligned(args[1])
    out_off, ldj_off = ct.coupling_step_tail(y_off, r_off, *args[2:])
    torch.testing.assert_close(out_off, out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ldj_off, ldj, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", STEP_SHAPES + [(3, 2, 3, 14)])
def test_coupling_step_tail_inverse_matches_plain(gen, shape):
    y, r, zb, zlogs, _ = _step_case(gen, shape)
    before = ct.coupling_tail_inverse.launches
    x = ct.coupling_step_tail_inverse(y, r, zb, zlogs)
    torch.cuda.synchronize()
    assert ct.coupling_tail_inverse.launches == before + 1
    torch.testing.assert_close(x, ct.coupling_step_tail_inverse_plain(y, r, zb, zlogs),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(x[..., : shape[-1] // 2], y[..., : shape[-1] // 2])
    assert torch.equal(x, ct.coupling_step_tail_inverse(y, r, zb, zlogs))  # the same bits
    # operands off 16-byte alignment take 4-byte accesses: same values
    x_off = ct.coupling_step_tail_inverse(_misaligned(y), _misaligned(r), zb, zlogs)
    torch.testing.assert_close(x_off, x, rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError, match="no gradient"):
        ct.coupling_step_tail_inverse(y, r.clone().requires_grad_(True), zb, zlogs)


@pytest.mark.parametrize("shape", STEP_SHAPES)
@pytest.mark.parametrize("given", ["both", "g_out", "g_ldj"])
def test_coupling_step_tail_bwd_matches_plain(gen, shape, given):
    y, r, zb, zlogs, _ = _step_case(gen, shape)
    g_out = _randn(gen, *shape) if given != "g_ldj" else None
    # an expanded scalar, as the mean of a loss hands it over: read in place
    g_ldj = _randn(gen, 1).expand(shape[0]) if given != "g_out" else None
    before = ct.coupling_tail_bwd.launches
    got = ct.coupling_step_tail_bwd(y, r, zb, zlogs, g_out, g_ldj)
    torch.cuda.synchronize()
    assert ct.coupling_tail_bwd.launches == before + 1
    want = ct.coupling_step_tail_bwd_plain(y, r, zb, zlogs, g_out, g_ldj)
    for name, a, e in zip(("d_y", "d_r", "d_zb", "d_zlogs"), got, want):
        tol = 1e-4 if name in ("d_zb", "d_zlogs") else 1e-5
        torch.testing.assert_close(a, e, rtol=tol, atol=tol, msg=name)
    again = ct.coupling_step_tail_bwd(y, r, zb, zlogs, g_out, g_ldj)
    for a, b in zip(got, again):
        assert torch.equal(a, b)  # the per-channel sums in a fixed order
    # the plain-operand backward with the same expanded g_ldj
    half = shape[-1] // 2
    h = (r + zb) * torch.exp(zlogs * 3.0)
    ls, bias, x_b = (h[..., :half].contiguous(), h[..., half:].contiguous(),
                     y[..., half:].contiguous())
    g_y = None if g_out is None else g_out[..., half:].contiguous()
    got = ct.coupling_tail_bwd(ls, bias, x_b, g_y, g_ldj)
    want = ct.coupling_tail_bwd_plain(ls, bias, x_b, g_y, g_ldj)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(64, 16, 16, 12), (64, 4, 4, 48), (5, 3, 5, 10)])
def test_coupling_step_tail_gradient_matches_autograd_of_plain(gen, shape):
    leaves = [t.requires_grad_(True) for t in _step_case(gen, shape)]
    out, ldj = ct.coupling_step_tail(*leaves)
    assert type(out.grad_fn).__name__ == "CouplingStepTailFunctionBackward"
    g_out, g_ldj = _randn(gen, *shape), _randn(gen, shape[0])
    fwd, bwd = ct.coupling_tail.launches, ct.coupling_tail_bwd.launches
    got = torch.autograd.grad((out, ldj), leaves, (g_out, g_ldj))
    assert (ct.coupling_tail.launches, ct.coupling_tail_bwd.launches) == (fwd, bwd + 1)
    want = torch.autograd.grad(ct.coupling_step_tail_plain(*leaves), leaves, (g_out, g_ldj))
    for i, (a, e) in enumerate(zip(got, want)):
        tol = 1e-4 if i in (2, 3) else 1e-5
        torch.testing.assert_close(a, e, rtol=tol, atol=tol)


def test_coupling_step_tail_bwd_on_two_streams_at_once(gen):
    """Each stream has its own ticket counter: launches that overlap on two
    streams give the bits of one stream's launches, and a graph captured on
    a stream replays them too."""
    args = [_step_case(gen, shape)[:4] + (_randn(gen, *shape), _randn(gen, shape[0]))
            for shape in ((64, 16, 16, 12), (64, 8, 8, 24))]
    want = [ct.coupling_step_tail_bwd(*a) for a in args]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(ct.coupling_step_tail_bwd(*args[i]))
    torch.cuda.synchronize()
    for i in range(2):
        for out in got[i]:
            assert all(torch.equal(a, b) for a, b in zip(out, want[i]))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=streams[0]):
        captured = ct.coupling_step_tail_bwd(*args[0])
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(captured, want[0]))
    # a stream that never launched it has no counter, and capture cannot make one
    fresh = torch.cuda.Stream()
    ct._tickets.pop((fresh.device_index, fresh.cuda_stream), None)
    with pytest.raises(RuntimeError, match="capturing stream"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=fresh):
            ct.coupling_step_tail_bwd(*args[0])


def test_coupling_step_tail_refuses_bad_inputs(gen):
    y, r, zb, zlogs, ldj = _step_case(gen, (2, 4, 4, 12))
    with pytest.raises(ValueError, match="contiguous"):
        ct.coupling_step_tail(y, r.transpose(1, 2), zb, zlogs, ldj)
    with pytest.raises(ValueError, match="zb and zlogs"):
        ct.coupling_step_tail(y, r, zb[:6], zlogs, ldj)
    with pytest.raises(ValueError, match="C even"):
        ct.coupling_step_tail(y[..., :11].contiguous(), r[..., :11].contiguous(),
                              zb[:11], zlogs[:11], ldj)
    with pytest.raises(ValueError, match="g_ldj"):
        ct.coupling_step_tail_bwd(y, r, zb, zlogs, None, ldj[:1])


@pytest.mark.parametrize("shape,o", [((64, 16, 16, 12), 12), ((64, 8, 8, 24), 24),
                                     ((64, 4, 4, 48), 48), ((37, 3, 5, 14), 20)])
def test_channel_mix_gradient_goes_through_the_kernel(gen, shape, o):
    x = _randn(gen, *shape).requires_grad_(True)
    w = _randn(gen, o, shape[-1], scale=0.3).requires_grad_(True)
    b = _randn(gen, o).requires_grad_(True)
    g = torch.cat([_randn(gen, *shape[:-1], o)] * 2, dim=-1)[..., o // 2: o // 2 + o]
    assert not g.is_contiguous()
    y = cm.channel_mix(x, w, b)
    assert y.grad_fn is not None
    launches, backward = cm.channel_mix.launches, cm.channel_mix.backward_launches
    got = torch.autograd.grad(y, (x, w, b), g)
    torch.cuda.synchronize()
    assert cm.channel_mix.launches == launches + 1
    assert cm.channel_mix.backward_launches == backward + 1
    want = torch.autograd.grad(cm.channel_mix_plain(x, w, b), (x, w, b), g)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-4)
    # only dW and db wanted (the input is data): no second launch
    y = cm.channel_mix(x.detach(), w, b)
    launches = cm.channel_mix.launches
    torch.autograd.grad(y, (w, b), g)
    assert cm.channel_mix.launches == launches


def test_kernel_outputs_carry_no_graph_where_none_is_asked_for(gen):
    x, w, b = _randn(gen, 4, 2, 2, 8), _randn(gen, 8, 8).requires_grad_(True), _randn(gen, 8)
    with torch.no_grad():
        assert cm.channel_mix(x, w, b).grad_fn is None
    with torch.inference_mode():
        assert ct.coupling_tail(x, x, x)[0].grad_fn is None


def test_wrappers_without_a_gradient_raise_under_grad(gen):
    x = _randn(gen, 2, 4, 4, 16).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient"):
        ct.coupling_tail_inverse(x, x, x)
    # fused_linear_attention has its gradient now: a graph, no error
    w_qkv, w_out, v = _randn(gen, 16, 384), _randn(gen, 128, 16), _randn(gen, 16)
    assert fla.fused_linear_attention(x, w_qkv, w_out, v, v).grad_fn is not None
    with torch.no_grad():
        assert ct.coupling_tail_inverse(x, x, x).shape == x.shape


# The 12 calls of one stage-2 training step at batch 64 (configs/nf_diffusion.yaml:
# three UNets of dim 64, [1, 2], over the parts (16,16,6), (8,8,12), (4,4,48)):
# per part at side H, linear attention at (side, C) = (H, 64), (H/2, 64), (H/2, 128),
# (H, 64): the two down levels at widths 64 and 64, the two up levels at 128 and 64.
TRAIN_SHAPES = [(64, s, s, c) for h in (16, 8, 4)
                for s, c in ((h, 64), (h // 2, 64), (h // 2, 128), (h, 64))]
# dx of the block, elementwise; the weight gradients sum over up to
# B*N = 16384 rows, so they are held to a bound scaled to the gradient's
# largest entry
BWD_ATOL_DX = 1e-4
BWD_SCALED = 1e-5


def _check_bwd_against_plain(args, dout, got):
    want = fla.fused_linear_attention_bwd_plain(*args, dout)
    torch.testing.assert_close(got[0], want[0], rtol=BWD_ATOL_DX, atol=BWD_ATOL_DX)
    for a, e in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, e, rtol=0, atol=BWD_SCALED * float(e.abs().max()))


BWD_SHAPES = TRAIN_SHAPES + [(5, 3, 5, 20), (2, 4, 4, 200), (5, 1, 65, 20), (5, 1, 257, 20),
                             (3, 1, 100, 200), (3, 1, 7, 7)]


@pytest.mark.parametrize("shape", BWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fused_linear_attention_bwd_matches_plain(gen, shape):
    c = shape[-1]
    x = _randn(gen, *shape).requires_grad_(True)
    w_qkv = _randn(gen, c, 384, scale=c ** -0.5).requires_grad_(True)
    w_out = _randn(gen, 128, c, scale=128 ** -0.5).requires_grad_(True)
    b_out = _randn(gen, c, scale=0.1).requires_grad_(True)
    g = (1.0 + _randn(gen, c, scale=0.1)).requires_grad_(True)
    dout = _randn(gen, *shape)
    leaves = (x, w_qkv, w_out, b_out, g)
    fwd, bwd = fla.fused_linear_attention.launches, fla.fused_linear_attention_bwd.launches
    y = fla.fused_linear_attention(*leaves)
    got = torch.autograd.grad(y, leaves, dout)
    torch.cuda.synchronize()
    assert (fla.fused_linear_attention.launches, fla.fused_linear_attention_bwd.launches) == (
        fwd + 1, bwd + 1)
    _check_bwd_against_plain([t.detach() for t in leaves], dout, got)
    # fixed order, no atomics: the same bits again
    again = torch.autograd.grad(fla.fused_linear_attention(*leaves), leaves, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# every plan the backward has, forced at shapes where each exists: fused (in
# one or two row tiles, N <= 32), and split in 64- and 32-token tiles
_BWD_PLAN_SHAPES = [(5, 3, 5, 20), (3, 4, 8, 64), (3, 1, 7, 7), (2, 4, 4, 128)]


@pytest.mark.parametrize("shape,plan", [
    *[(s, p) for s in _BWD_PLAN_SHAPES for p in ((True, None), (False, 4), (False, 2))],
    ((4, 8, 8, 64), (False, 4)), ((4, 8, 8, 64), (False, 2))],
    ids=lambda v: "x".join(map(str, v)) if len(v) == 4 else
    {(True, None): "fused", (False, 4): "split64", (False, 2): "split32"}[v])
def test_fused_linear_attention_bwd_each_plan_matches_plain(gen, shape, plan, monkeypatch):
    args = _attention_case(gen, shape)
    dout = _randn(gen, *shape)
    n, c = shape[1] * shape[2], shape[-1]
    forced = fla.Plan(True, -(-n // 16)) if plan[0] else fla.Plan(*plan)
    assert fla.bwd_smem_bytes(forced.fused, forced.m_tiles, c) <= 232448
    _, ctx, stats = fla._forward_kernel(*args)
    monkeypatch.setattr(fla, "bwd_plan", lambda n_, c_: forced)
    before = fla.fused_linear_attention_bwd.launches
    got = fla.fused_linear_attention_bwd(*args, ctx, stats, dout)
    torch.cuda.synchronize()
    assert fla.fused_linear_attention_bwd.launches == before + 1
    _check_bwd_against_plain(args, dout, got)
    again = fla.fused_linear_attention_bwd(*args, ctx, stats, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("shape", BWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_attention_bwd_plan_smem_matches_the_kernel(gen, shape):
    """The shared memory the backward's plan is checked with is what its
    kernels lay out, for the plan of the shape and for both split tilings."""
    kernel_smem = fla._build.function("attention_kernels", "fused_linear_attention_bwd_smem_bytes")
    n, c = shape[1] * shape[2], shape[-1]
    p = fla.bwd_plan(n, c)
    for fused, m_tiles in {tuple(p), (False, 4), (False, 2)}:
        assert fla.bwd_smem_bytes(fused, m_tiles, c) == kernel_smem(int(fused), m_tiles, c)


def test_wrappers_raise_on_bad_inputs(gen):
    x = _randn(gen, 4, 8)
    with pytest.raises(TypeError):
        cm.channel_mix(x.double(), _randn(gen, 8, 8).double(), _randn(gen, 8).double())
    with pytest.raises(ValueError, match="contiguous"):
        cm.channel_mix(_randn(gen, 8, 4).T, _randn(gen, 8, 8), _randn(gen, 8))
    with pytest.raises(ValueError, match="CUDA device"):
        cm.channel_mix(x, _randn(gen, 8, 8).cpu(), _randn(gen, 8))
    with pytest.raises(ValueError, match="shape"):
        ct.coupling_tail(x, x, _randn(gen, 4, 9))
    x4 = _randn(gen, 2, 4, 4, 16)
    w_qkv, w_out, v = _randn(gen, 16, 384), _randn(gen, 128, 16), _randn(gen, 16)
    with pytest.raises(ValueError, match="w_qkv"):
        fla.fused_linear_attention(x4, _randn(gen, 16, 96), w_out, v, v)
    with pytest.raises(ValueError, match="heads"):
        fla.fused_linear_attention(x4, w_qkv, w_out, v, v, heads=2, dim_head=64)


def _megakernel_case(gen, b, h, w, c, width):
    """x, w_fold, b_fold and a coupling net with every leaf random (the
    zeroconv and the actnorms too), conv weights channels-last as the port
    keeps them."""
    def conv(*shape, scale):
        return _randn(gen, *shape, scale=scale).to(memory_format=torch.channels_last)

    net = {"conv1": {"w": conv(width, c // 2, 3, 3, scale=(9 * c / 2) ** -0.5)},
           "an1": {"scale": _randn(gen, width, scale=0.1), "bias": _randn(gen, width, scale=0.1)},
           "conv2": {"w": conv(width, width, 1, 1, scale=width ** -0.5)},
           "an2": {"scale": _randn(gen, width, scale=0.1), "bias": _randn(gen, width, scale=0.1)},
           "zconv": {"w": conv(c, width, 3, 3, scale=0.02), "b": _randn(gen, c, scale=0.05),
                     "logs": _randn(gen, c, scale=0.05)}}
    return (_randn(gen, b, h, w, c), _randn(gen, c, c, scale=c ** -0.5),
            _randn(gen, c, scale=0.1), net)


# the three level shapes of the served Glow (L3/K4/w512, batch 64), the JAX
# package's test case, a ragged one (odd batch, odd H and W, C not a
# multiple of 4, a width that no chunk divides) and blocks of four whole
# images
@pytest.mark.parametrize("shape", [(64, 16, 16, 12, 512), (64, 8, 8, 24, 512),
                                   (64, 4, 4, 48, 512), (5, 16, 16, 12, 64),
                                   (7, 5, 9, 14, 44), (16, 2, 2, 48, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_step_megakernel_matches_plain(gen, shape):
    nfdpm_tpu_torch.disable_tf32()  # the plain version's convolutions in full fp32
    x, wf, bf, net = _megakernel_case(gen, *shape)
    before = sm.step_megakernel_forward.launches
    y, ldj = sm.step_megakernel_forward(x, wf, bf, net)
    torch.cuda.synchronize()
    assert sm.step_megakernel_forward.launches == before + 1
    y_p, ldj_p = sm.step_megakernel_forward_plain(x, wf, bf, net)
    torch.testing.assert_close(y, y_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ldj, ldj_p, rtol=1e-5, atol=1e-3)
    # fixed order, no atomics: the same bits again
    y2, ldj2 = sm.step_megakernel_forward(x, wf, bf, net)
    assert torch.equal(y, y2) and torch.equal(ldj, ldj2)


def test_step_megakernel_refuses_gradient_and_bad_inputs(gen):
    x, wf, bf, net = _megakernel_case(gen, 2, 4, 4, 8, 16)
    with pytest.raises(RuntimeError, match="no gradient"):
        sm.step_megakernel_forward(x, wf.clone().requires_grad_(True), bf, net)
    with torch.no_grad():
        assert sm.step_megakernel_forward(x, wf.clone().requires_grad_(True), bf, net)[0].shape \
            == x.shape
    with pytest.raises(ValueError, match="odd"):
        sm.step_megakernel_forward(_randn(gen, 2, 4, 4, 7), wf, bf, net)
    wide = dict(net, conv2={"w": _randn(gen, 24, 24, 1, 1)})
    with pytest.raises(ValueError, match="conv2.w"):
        sm.step_megakernel_forward(x, wf, bf, wide)
    with pytest.raises(ValueError, match="contiguous"):
        sm.step_megakernel_forward(x.transpose(1, 2), wf, bf, net)
    with pytest.raises(TypeError):
        sm.step_megakernel_forward(x.double(), wf.double(), bf.double(), net)
    ragged = _megakernel_case(gen, 2, 4, 4, 8, 18)
    with pytest.raises(ValueError, match="multiples of 4"):
        sm.step_megakernel_forward(*ragged)


@pytest.mark.parametrize("shape", [(16, 16, 12, 512), (8, 8, 24, 512), (4, 4, 48, 512),
                                   (16, 16, 12, 64), (5, 9, 14, 44), (2, 2, 48, 512),
                                   (4, 4, 8, 18), (4, 4, 64, 512), (3, 300, 12, 512)])
def test_step_megakernel_smem_matches_the_kernel(gen, shape):
    """The wrapper's smem_bytes against the kernel's own layout for every
    plan (mt, stages); the kernel refuses what the plan check refuses."""
    from nfdpm_tpu_torch.ops.kernels import _build

    h, w, c, d = shape
    smem = _build.function("step_megakernel", "step_megakernel_smem_bytes")
    for mt in (1, 2, 3, 4):
        for stages in (1, 2, 3, 4, 5):
            want = sm.smem_bytes(w, c, d, mt, stages)
            fits = (mt in (1, 2, 4) and 2 <= stages <= 4 and d % 4 == 0
                    and -(-sm.z_cols(c) // 64) <= 8 // mt and want <= 232448)
            assert smem(h, w, c, d, mt, stages) == (want if fits else -1), (mt, stages)


def test_step_megakernel_entry_refuses_a_plan_that_does_not_hold(gen, monkeypatch):
    x, wf, bf, net = _megakernel_case(gen, 2, 4, 4, 8, 16)
    packed = sm.pack(wf, bf, net, 8)
    good = sm.plan(2, 4, 4, 8, 16)
    for bad in (good._replace(mt=3), good._replace(stages=5)):
        monkeypatch.setattr(sm, "plan", lambda *args, _p=bad: _p)
        with pytest.raises(RuntimeError, match="launch failed"):
            sm.launch(x, packed, 16)
