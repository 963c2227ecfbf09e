"""The Glow step tail of nfdpm_tpu_torch (ops/kernels/coupling_tail.py:
coupling_step_tail, its hand-written backward, and the kernel route of the
Glow step that launches it) held against nfdpm_tpu on the CPU.

The JAX side is the composition the step tail takes in: the zeroconv
(ops/zeroconv.py: zeroconv_apply), its output's halves, the Pallas
coupling_tail in interpret mode, jnp.concatenate and the logdet add. Inputs
are made with numpy from a seed, at the three level widths of the default
Glow (C = 12, 24, 48) and a ragged shape (B = 5, C = 10, 3x5 pixels).
Tolerances: values atol 1e-5, logdets rtol 1e-5 and atol 1e-4 (sums of up
to a few hundred fp32 terms in another order); the backward against
jax.vjp rtol 1e-4 and atol 1e-6 (d_zb and d_zlogs sum over B x H x W
pixels); the autograd Function against autograd through the plain version
rtol 1e-5 and atol 1e-6 (the same terms, d_zlogs summed as 3 d_h h there
and as 3 e sum d_h (r + zb) by autograd). The inverse step tail
(coupling_step_tail_inverse) is held against the JAX inverse composition
(the zeroconv, the Pallas coupling_tail_inverse in interpret mode,
jnp.concatenate) at the same shapes and a ragged C = 14, atol 1e-5; a
round trip through the forward step tail within 2e-3 (the bound of
tests/test_pallas_kernels.py); the inverse step and a small Glow's
inverse through the kernel route against step_inverse_pallas. The plans
of the three kernels are pure Python and are held here too: their grids
cover every unit or pixel exactly once, the forward's and the inverse's
fill the card at the level shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, one_torch_thread, port_tree, randomize, t
from nfdpm_tpu.ops import bijectors as jbj
from nfdpm_tpu.ops import zeroconv as jzc
from nfdpm_tpu.ops.pallas import coupling_tail as jct
from nfdpm_tpu_torch.ops import bijectors as tbj
from nfdpm_tpu_torch.ops import coupling as tcoupling
from nfdpm_tpu_torch.ops import zeroconv as tzc
from nfdpm_tpu_torch.ops.kernels import coupling_tail as ct

LDJ_TOL = dict(rtol=1e-5, atol=1e-4)
VJP_TOL = dict(rtol=1e-4, atol=1e-6)
# (B, H, W, C): the three level shapes of the default Glow (cut to batch 2)
# and a ragged one
SHAPES = [(2, 16, 16, 12), (2, 8, 8, 24), (2, 4, 4, 48), (5, 3, 5, 10)]
WIDTH = 8  # the zeroconv's input channels (the coupling CNN's width)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _case(shape, seed=0):
    """y, the zeroconv's input h_in, its JAX params (HWIO) and ldj."""
    b, h, w, c = shape
    zc = randomize(jzc.init_zeroconv(WIDTH, c, filter_size=3), seed=seed, scale=0.2)
    return (_normal(seed + 1, shape), _normal(seed + 2, (b, h, w, WIDTH)), zc,
            _normal(seed + 3, (b,), 10.0))


def _jax_tail(zc, y, h_in, ldj):
    """The JAX composition the step tail replaces (nfdpm_tpu's
    step_forward_pallas from the coupling CNN's last layer on)."""
    half = y.shape[-1] // 2
    net_out = jzc.zeroconv_apply(zc, h_in)
    y_b, part = jct.coupling_tail(net_out[..., :half], net_out[..., half:], y[..., half:], True)
    return jnp.concatenate([y[..., :half], y_b], axis=-1), ldj + part


def _port_operands(zc, y, h_in, ldj):
    """y, r (the zeroconv's raw convolution, through the port's conv), zb,
    zlogs and ldj as CPU tensors."""
    zp = port_tree(zc)
    r = tzc.conv2d_nhwc(t(h_in), zp["w"], padding=1)
    return t(y), r, zp["b"], zp["logs"], t(ldj)


@pytest.mark.parametrize("shape", SHAPES)
def test_step_tail_plain_matches_jax_composition(shape):
    y, h_in, zc, ldj = _case(shape)
    out_j, ldj_j = _jax_tail(zc, *map(jnp.asarray, (y, h_in, ldj)))
    args = _port_operands(zc, y, h_in, ldj)
    out_t, ldj_t = ct.coupling_step_tail_plain(*args)
    close(out_t, out_j)
    close(ldj_t, ldj_j, **LDJ_TOL)
    # the entry point takes the plain version on CPU tensors, launching nothing
    before = ct.coupling_tail.launches
    out_e, ldj_e = ct.coupling_step_tail(*args)
    assert ct.coupling_tail.launches == before
    assert torch.equal(out_e, out_t) and torch.equal(ldj_e, ldj_t)


def test_coupling_net_conv_is_the_net_before_the_epilogue():
    from nfdpm_tpu.ops import coupling as jcoupling

    params = randomize(jcoupling.init_coupling_net(np.random.default_rng(0), 4, 16, 8),
                       seed=1, scale=0.1)
    x = _normal(2, (2, 6, 6, 4))
    tp = port_tree(params)
    r = tcoupling.coupling_net_conv(tp, t(x))
    zc = tp["zconv"]
    close((r + zc["b"]) * torch.exp(zc["logs"] * 3.0),
          jcoupling.coupling_net_apply(params, jnp.asarray(x)))
    close((r + zc["b"]) * torch.exp(zc["logs"] * 3.0),
          tcoupling.coupling_net_apply(tp, t(x)), atol=0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("given", ["both", "g_out", "g_ldj"])
def test_step_tail_bwd_plain_matches_jax_vjp(shape, given):
    """The hand-written backward against jax.vjp of the composition, taken
    at r through a 1x1 identity zeroconv (conv(r) = r exactly), so that the
    vjp's input cotangent is d_r."""
    b, h, w, c = shape
    y, _, zc, ldj = _case(shape, seed=5)
    r = _normal(9, shape, 0.5)
    zb, zlogs = zc["b"], zc["logs"]

    def composition(y, r, zb, zlogs, ldj):
        ident = {"w": jnp.eye(c, dtype=jnp.float32)[None, None], "b": zb, "logs": zlogs}
        return _jax_tail(ident, y, r, ldj)

    _, vjp = jax.vjp(composition, *map(jnp.asarray, (y, r, zb, zlogs, ldj)))
    g_out = _normal(11, shape) if given != "g_ldj" else None
    g_ldj = _normal(12, (b,)) if given != "g_out" else None
    want = vjp((jnp.zeros(shape, jnp.float32) if g_out is None else jnp.asarray(g_out),
                jnp.zeros((b,), jnp.float32) if g_ldj is None else jnp.asarray(g_ldj)))
    got = ct.coupling_step_tail_bwd_plain(
        t(y), t(r), t(zb), t(zlogs), None if g_out is None else t(g_out),
        None if g_ldj is None else t(g_ldj))
    for name, a, e in zip(("d_y", "d_r", "d_zb", "d_zlogs"), got, want[:4]):
        close(a, e, **VJP_TOL)
        assert a.shape == e.shape, name
    # the running ldj's cotangent is g_ldj itself
    close(np.zeros(b, np.float32) if g_ldj is None else g_ldj, want[4], atol=0)
    # the step-mode wrapper takes the plain version on CPU tensors
    again = ct.coupling_step_tail_bwd(t(y), t(r), t(zb), t(zlogs),
                                      None if g_out is None else t(g_out),
                                      None if g_ldj is None else t(g_ldj))
    for a, e in zip(again, got):
        assert torch.equal(a, e)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("given", ["both", "g_out", "g_ldj"])
def test_step_tail_function_matches_autograd_of_plain(shape, given):
    b = shape[0]
    y, h_in, zc, ldj = _case(shape, seed=20)
    leaves = [a.clone().requires_grad_(True) for a in _port_operands(zc, y, h_in, ldj)]
    out, ldj_out = ct.coupling_step_tail(*leaves)
    assert type(out.grad_fn).__name__ == "CouplingStepTailFunctionBackward"
    out_p, ldj_p = ct.coupling_step_tail_plain(*leaves)
    assert torch.equal(out, out_p) and torch.equal(ldj_out, ldj_p)
    # cotangents as autograd may hand them over: a slice of a wider tensor
    # and an expanded scalar
    g_out = torch.cat([t(_normal(21, shape))] * 2, dim=-1)[..., : shape[-1]]
    g_ldj = t(_normal(22, (1,))).expand(b)
    outs, outs_p, cots = {
        "both": ((out, ldj_out), (out_p, ldj_p), (g_out, g_ldj)),
        "g_out": ((out,), (out_p,), (g_out,)),
        "g_ldj": ((ldj_out,), (ldj_p,), (g_ldj,))}[given]
    got = torch.autograd.grad(outs, leaves, cots, allow_unused=True)
    want = torch.autograd.grad(outs_p, leaves, cots, allow_unused=True)
    for a, e, leaf in zip(got, want, leaves):
        a = torch.zeros_like(leaf) if a is None else a
        e = torch.zeros_like(leaf) if e is None else e
        close(a, e.detach().numpy(), rtol=1e-5, atol=1e-6)


def test_step_tail_saves_nothing_where_no_gradient_is_asked_for():
    y, h_in, zc, ldj = _case(SHAPES[-1])
    leaves = [a.requires_grad_(True) for a in _port_operands(zc, y, h_in, ldj)]
    with torch.no_grad():
        assert ct.coupling_step_tail(*leaves)[0].grad_fn is None
    with torch.inference_mode():
        assert ct.coupling_step_tail(*leaves)[1].grad_fn is None


@pytest.mark.parametrize("fn,shapes", [
    (ct.coupling_step_tail, ((2, 3, 4), (2, 3, 4), (4,), (4,), (2,))),
    (ct.coupling_step_tail_bwd, ((2, 3, 4), (2, 3, 4), (4,), (4,), (2, 3, 4), (2,))),
])
def test_step_tail_wrappers_refuse_non_cuda_devices(fn, shapes):
    """Only a CPU tensor takes the plain version; any other device must
    launch the kernel or raise, never fall back silently."""
    with pytest.raises(ValueError, match="CUDA"):
        fn(*[torch.empty(s, device="meta") for s in shapes])


def _step(c, seed, width=16):
    return randomize(jbj.init_step(seed, c, width, "plu"), seed=seed + 50, scale=0.05)


@pytest.mark.parametrize("shape", SHAPES)
def test_step_forward_kernels_matches_step_forward_pallas(shape):
    sp = _step(shape[-1], 7)
    x, ldj = _normal(1, shape), _normal(2, shape[:1])
    y_j, ldj_j = jbj.step_forward_pallas(sp, jnp.asarray(x), jnp.asarray(ldj))
    y_t, ldj_t = tbj.step_forward_kernels(port_tree(sp), t(x), t(ldj))
    close(y_t, y_j)
    close(ldj_t, ldj_j, **LDJ_TOL)


# the step's leaves whose gradients the JAX package also takes (p_mat and
# sign stay fixed: invconv_weight stops their gradient there)
STEP_LEAVES = [("actnorm", "scale"), ("actnorm", "bias"), ("invconv", "lower"),
               ("invconv", "upper"), ("invconv", "log_s")] + [
    ("coupling", "net", layer, leaf)
    for layer, leaves in (("conv1", ("w",)), ("an1", ("scale", "bias")), ("conv2", ("w",)),
                          ("an2", ("scale", "bias")), ("zconv", ("w", "b", "logs")))
    for leaf in leaves]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("shape", [(2, 8, 8, 12), (5, 3, 5, 10)])
def test_step_forward_kernels_gradient_matches_jax_grad(shape):
    """The gradient of a step through the kernel route (channel mix and
    step tail, both hand-written Functions) against jax.grad of
    step_forward_pallas, for the input and every trainable leaf."""
    sp = _step(shape[-1], 13)
    x, ldj = _normal(3, shape), _normal(4, shape[:1])
    w_y, w_l = _normal(5, shape), _normal(6, shape[:1])

    def loss_j(sp, x, ldj):
        y, l = jbj.step_forward_pallas(sp, x, ldj)
        return jnp.sum(y * w_y) + jnp.sum(l * w_l)

    g_sp, g_x, g_ldj = jax.grad(loss_j, argnums=(0, 1, 2))(sp, jnp.asarray(x), jnp.asarray(ldj))
    tp = port_tree(sp)
    leaves = [_get(tp, p).requires_grad_(True) for p in STEP_LEAVES]
    xt, lt = t(x).requires_grad_(True), t(ldj).requires_grad_(True)
    y, l = tbj.step_forward_kernels(tp, xt, lt)
    assert type(y.grad_fn).__name__ == "CouplingStepTailFunctionBackward"
    loss = torch.sum(y * t(w_y)) + torch.sum(l * t(w_l))
    got = torch.autograd.grad(loss, [xt, lt] + leaves)
    close(got[0], g_x, **VJP_TOL)
    close(got[1], g_ldj, **VJP_TOL)
    for path, a in zip(STEP_LEAVES, got[2:]):
        e = np.asarray(_get(g_sp, path))
        if path[-1] == "w":  # HWIO on the JAX side, OIHW in the port
            e = e.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(a.numpy(), e, err_msg=str(path), **VJP_TOL)


# --- the inverse step tail ---

INVERSE_SHAPES = SHAPES + [(3, 2, 3, 14)]  # and a ragged C/2 = 7


def _jax_inverse_tail(zc, y, h_in):
    """The JAX composition the inverse step tail replaces (nfdpm_tpu's
    step_inverse_pallas from the coupling CNN's last layer to the concat)."""
    half = y.shape[-1] // 2
    net_out = jzc.zeroconv_apply(zc, h_in)
    x_b = jct.coupling_tail_inverse(net_out[..., :half], net_out[..., half:], y[..., half:],
                                    True)
    return jnp.concatenate([y[..., :half], x_b], axis=-1)


@pytest.mark.parametrize("shape", INVERSE_SHAPES)
def test_step_tail_inverse_plain_matches_jax_composition(shape):
    y, h_in, zc, ldj = _case(shape, seed=30)
    x_j = _jax_inverse_tail(zc, jnp.asarray(y), jnp.asarray(h_in))
    y_t, r, zb, zlogs, _ = _port_operands(zc, y, h_in, ldj)
    x_t = ct.coupling_step_tail_inverse_plain(y_t, r, zb, zlogs)
    close(x_t, x_j)
    assert torch.equal(x_t[..., : shape[-1] // 2], y_t[..., : shape[-1] // 2])
    # the entry point takes the plain version on CPU tensors, launching nothing
    before = ct.coupling_tail_inverse.launches
    assert torch.equal(ct.coupling_step_tail_inverse(y_t, r, zb, zlogs), x_t)
    assert ct.coupling_tail_inverse.launches == before


@pytest.mark.parametrize("shape", INVERSE_SHAPES)
def test_step_tail_inverse_undoes_the_step_tail(shape):
    """The inverse divides by s + 1e-6, so it undoes the forward only to
    about 1e-6 / s relative: the round trip is held with the zeroconv's
    leaves at the scale the port's tests give a Glow's zero-initialised
    leaves (0.05, as `_step`), where s stays near sigmoid(2)."""
    b, h, w, c = shape
    zc = randomize(jzc.init_zeroconv(WIDTH, c, filter_size=3), seed=40, scale=0.05)
    y, h_in, ldj = _normal(41, shape), _normal(42, (b, h, w, WIDTH)), _normal(43, (b,), 10.0)
    y_t, r, zb, zlogs, ldj_t = _port_operands(zc, y, h_in, ldj)
    out, _ = ct.coupling_step_tail(y_t, r, zb, zlogs, ldj_t)
    close(ct.coupling_step_tail_inverse(out, r, zb, zlogs), y, atol=2e-3)


def test_step_tail_inverse_refuses_a_gradient():
    y, h_in, zc, ldj = _case(SHAPES[-1], seed=41)
    y_t, r, zb, zlogs, _ = _port_operands(zc, y, h_in, ldj)
    with pytest.raises(RuntimeError, match="no gradient"):
        ct.coupling_step_tail_inverse(y_t, r.requires_grad_(True), zb, zlogs)
    with torch.no_grad():
        assert ct.coupling_step_tail_inverse(y_t, r, zb, zlogs).shape == y_t.shape
    with pytest.raises(ValueError, match="CUDA"):
        ct.coupling_step_tail_inverse(*[torch.empty(s, device="meta")
                                        for s in ((2, 3, 4), (2, 3, 4), (4,), (4,))])


@pytest.mark.parametrize("shape", INVERSE_SHAPES)
def test_step_inverse_kernels_matches_step_inverse_pallas(shape):
    sp = _step(shape[-1], 17)
    y = _normal(8, shape)
    x_j = jbj.step_inverse_pallas(sp, jnp.asarray(y))
    # a view, as a split hands it over (channels of a wider tensor)
    y_view = torch.cat([t(y), t(y)], dim=-1)[..., : shape[-1]]
    assert not y_view.is_contiguous()
    x_t = tbj.step_inverse_kernels(port_tree(sp), y_view)
    close(x_t, x_j)
    x_back, _ = tbj.step_forward_kernels(port_tree(sp), x_t, torch.zeros(shape[0]))
    close(x_back, y, atol=2e-3)


def test_glow_inverse_kernel_route_matches_jax():
    """A small Glow (L2/K2, width 16, 8x8x3) inverted from seeded latents
    through the kernel route on the CPU against nfdpm_tpu's inverse through
    step_inverse_pallas."""
    from _torch_port import to_numpy_tree
    from nfdpm_tpu.models import glow as jglow
    from nfdpm_tpu_torch.convert import from_jax_params
    from nfdpm_tpu_torch.models import glow as tglow

    kw = dict(in_channels=3, levels=2, steps=2, coupling_width=16)
    jcfg, tcfg = jglow.GlowConfig(use_pallas=True, **kw), tglow.GlowConfig(use_kernels=True, **kw)
    flow = randomize(to_numpy_tree(jglow.init_glow(3, jcfg)), seed=4)
    shapes = tglow.latent_shapes_nhwc(tcfg, 8)
    lats = [_normal(60 + i, (2, *s)) for i, s in enumerate(shapes)]
    x_j = jglow.inverse(jax.tree.map(jnp.asarray, flow), jcfg, [jnp.asarray(z) for z in lats])
    tflow = from_jax_params({"flow": flow}, "cpu")["flow"]
    before = ct.coupling_tail_inverse.launches
    x_t = tglow.inverse(tflow, tcfg, [t(z) for z in lats])
    assert ct.coupling_tail_inverse.launches == before  # CPU tensors: the plain versions
    close(x_t, x_j)


# --- the kernels' plans (pure Python: the grids as the kernels walk them) ---

LEVELS = [(64, 16 * 16, 12), (64, 8 * 8, 24), (64, 4 * 4, 48)]  # (B, H W, C) at batch 64


def _forward_units(p, rows, px, half):
    """How often the forward kernel's grid (blocks x rows, p.threads a
    block, the threads walking an image's units at a stride of
    blocks x threads) reaches each (image, pixel, unit)."""
    q_n = half // p.vw
    units = px * q_n
    counts = np.zeros((rows, units), np.int64)
    for u in range(p.blocks * p.threads):
        counts[:, u:units:p.blocks * p.threads] += 1
    return counts


def _backward_pixels(p, rows, px, half):
    """How often the backward kernel's lanes reach each pixel of the batch,
    and the number of threads that meet each pair-chunk of a pixel."""
    q_n = half // p.vw
    lanes = p.threads // q_n
    n_px = rows * px
    counts = np.zeros(n_px, np.int64)
    for blk in range(p.blocks):
        start, end = blk * lanes * p.px_per_lane, min(n_px, (blk + 1) * lanes * p.px_per_lane)
        for lane in range(lanes):
            counts[start + lane:end:lanes] += 1
    return counts, lanes * q_n <= p.threads


# every access width the wrapper may pick for each shape (C/2 divisible by it)
PLAN_CASES = [(rows, px, c, vw)
              for rows, px, c in LEVELS + [(5, 15, 10), (3, 1, 2), (1, 7, 512), (2, 4096, 48),
                                         (16, 4096, 48)]
              for vw in (4, 2, 1) if (c // 2) % vw == 0]


@pytest.mark.parametrize("rows,px,c,vw", PLAN_CASES)
def test_step_tail_plans_cover_every_unit_once(rows, px, c, vw):
    half = c // 2
    f = ct.forward_plan(rows, px, half, vw)
    assert f.threads in (32, 64, 128, 256, 512) and f.vw == vw
    assert 1 <= f.blocks <= ct.MAX_CLUSTER  # one cluster an image
    assert (_forward_units(f, rows, px, half) == 1).all()
    i = ct.inverse_plan(rows, px, half, vw)
    assert i.threads in (32, 64, 128) and i.vw == vw and 1 <= i.blocks <= ct.MAX_INVERSE_BLOCKS
    units = rows * px * (half // vw)
    reached = np.zeros(units, np.int64)
    for u in range(i.blocks * i.threads):  # a thread a unit, a loop past the grid
        reached[u:units:i.blocks * i.threads] += 1
    assert (reached == 1).all()
    b = ct.backward_plan(rows, px, half, vw)
    counts, fits = _backward_pixels(b, rows, px, half)
    assert fits and (counts == 1).all() and b.blocks <= ct.SMS
    # shared memory of the backward's step mode (csrc: tail_smem_floats)
    lanes = b.threads // (half // vw)
    assert 4 * (2 * c + lanes * 2 * c + b.threads) <= 48 * 1024


def test_step_tail_plans_at_the_level_shapes():
    """The forward's and the inverse's grids have a block per SM at every
    level shape; the
    access width is 16 bytes where C/2 allows it (levels 2 and 3) and 8
    at level 1 (C/2 = 6)."""
    want_vw = [2, 4, 4]
    for (rows, px, c), vw in zip(LEVELS, want_vw):
        assert ct.vector_width(c // 2, 0, 256, 4096) == vw
        f = ct.forward_plan(rows, px, c // 2, vw)
        assert rows * f.blocks >= ct.SMS, (rows, px, c, f)
    assert [ct.forward_plan(r, p, c // 2, v).threads
            for (r, p, c), v in zip(LEVELS, want_vw)] == [128, 64, 32]
    assert [ct.forward_plan(r, p, c // 2, v).blocks
            for (r, p, c), v in zip(LEVELS, want_vw)] == [6, 3, 3]
    # the inverse: one unit a thread, 384, 192 and 192 blocks
    assert [tuple(ct.inverse_plan(r, p, c // 2, v))[1:3]
            for (r, p, c), v in zip(LEVELS, want_vw)] == [(128, 384), (64, 192), (32, 192)]
    assert [tuple(ct.backward_plan(r, p, c // 2, v))[1:]
            for (r, p, c), v in zip(LEVELS, want_vw)] == [(512, 97, 1), (256, 49, 1),
                                                          (256, 25, 1)]
    # a pointer off 16 bytes, or an odd half, takes a narrower access
    assert ct.vector_width(12, 8) == 2 and ct.vector_width(12, 4) == 1
    assert ct.vector_width(5, 0) == 1
