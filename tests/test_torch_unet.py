"""The UNet of nfdpm_tpu_torch and its linear-attention kernel's plain
version, held against nfdpm_tpu on the CPU.

Weights come from the flax modules' init with every leaf given seeded noise
(so no bias is zero and no gain one), inputs from numpy seeds. Tolerances:
the kernel's plain version atol 1e-5 and rtol 1e-5; single UNet modules and
the whole UNet atol 1e-4 (sums over up to 9·C products taken in another
order, through several normalisations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, one_torch_thread, randomize, t, to_numpy_tree
from nfdpm_tpu.models import unet as junet
from nfdpm_tpu.ops.pallas import fused_linear_attention as jfla
from nfdpm_tpu_torch import convert
from nfdpm_tpu_torch.models import unet as tunet
from nfdpm_tpu_torch.ops.kernels import fused_linear_attention as tfla

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


UNET_TOL = dict(atol=1e-4, rtol=0.0)


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _flax(module, *inputs, seed=0):
    """(randomized numpy params, apply(*inputs) -> numpy) of a flax module."""
    variables = module.init(jax.random.PRNGKey(seed), *inputs)
    params = randomize(to_numpy_tree(variables["params"]), seed=seed + 1)

    def apply(*args):
        return np.asarray(module.apply({"params": jax.tree.map(jnp.asarray, params)}, *args))

    return params, apply


def _assign(module, values):
    """Set the port module's parameters from {name: numpy array}; every
    parameter must be given."""
    params = dict(module.named_parameters())
    assert sorted(values) == sorted(params)
    with torch.no_grad():
        for name, a in values.items():
            assert tuple(params[name].shape) == a.shape, name
            params[name].copy_(torch.from_numpy(np.ascontiguousarray(a)))
    return module


def _oihw(w):
    return np.asarray(w).transpose(3, 2, 0, 1)


def _mat(w):
    w = np.asarray(w)
    return w.reshape(w.shape[-2], w.shape[-1])


# -- the kernel's plain version ---------------------------------------------

FLA_CASES = [(2, 4, 4, 16), (3, 3, 5, 20), (1, 8, 8, 64), (5, 1, 1, 7)]


def _fla_inputs(b, h, w, c, seed=0, hidden=128):
    x = _rand(seed, b, h, w, c)
    w_qkv = _rand(seed + 1, c, 3 * hidden, scale=c ** -0.5)
    w_out = _rand(seed + 2, hidden, c, scale=hidden ** -0.5)
    return x, w_qkv, w_out, _rand(seed + 3, c, scale=0.1), 1.0 + _rand(seed + 4, c, scale=0.1)


@pytest.mark.parametrize("shape", FLA_CASES, ids=["x".join(map(str, s)) for s in FLA_CASES])
def test_fused_linear_attention_plain_matches_reference(shape):
    x, w_qkv, w_out, b_out, g = _fla_inputs(*shape)
    expected = jfla._reference_impl(jnp.asarray(x), jnp.asarray(w_qkv), jnp.asarray(w_out),
                                    jnp.asarray(b_out), jnp.asarray(g), 4, 32)
    got = tfla.fused_linear_attention_plain(t(x), t(w_qkv), t(w_out), t(b_out), t(g))
    close(got, expected, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", FLA_CASES[:2], ids=["x".join(map(str, s))
                                                      for s in FLA_CASES[:2]])
def test_fused_linear_attention_plain_matches_pallas_kernel(shape):
    """Against the TPU kernel itself, run in interpret mode; weights in the
    kernel's HWIO layout."""
    x, w_qkv, w_out, b_out, g = _fla_inputs(*shape, seed=7)
    c = shape[-1]
    expected = jfla.fused_linear_attention(
        jnp.asarray(x), jnp.asarray(w_qkv.reshape(1, 1, c, -1)),
        jnp.asarray(w_out.reshape(1, 1, -1, c)), jnp.asarray(b_out), jnp.asarray(g),
        4, 32, True)
    got = tfla.fused_linear_attention(t(x), t(w_qkv), t(w_out), t(b_out), t(g))
    close(got, expected, atol=1e-5, rtol=1e-5)


def test_fused_linear_attention_on_cpu_takes_plain_and_counts_nothing():
    x, w_qkv, w_out, b_out, g = (t(a) for a in _fla_inputs(2, 2, 3, 8))
    before = tfla.fused_linear_attention.launches
    a = tfla.fused_linear_attention(x, w_qkv, w_out, b_out, g)
    assert tfla.fused_linear_attention.launches == before
    assert torch.equal(a, tfla.fused_linear_attention_plain(x, w_qkv, w_out, b_out, g))


# -- single modules ---------------------------------------------------------

def test_weight_standardized_conv():
    x = _rand(1, 2, 6, 6, 5)
    p, apply = _flax(junet.WeightStandardizedConv(7), jnp.asarray(x))
    m = _assign(tunet.WeightStandardizedConv(5, 7, 3, padding=1),
                {"weight": _oihw(p["kernel"]), "bias": p["bias"]})
    close(m(t(x)), apply(jnp.asarray(x)), **UNET_TOL)


def test_channel_layer_norm():
    x = _rand(2, 3, 4, 4, 6, scale=3.0) + 1.0
    p, apply = _flax(junet.ChannelLayerNorm(), jnp.asarray(x))
    m = _assign(tunet.ChannelLayerNorm(6), {"g": p["g"]})
    close(m(t(x)), apply(jnp.asarray(x)), atol=1e-5)


@pytest.mark.parametrize("learned", [False, True])
def test_time_embeddings(learned):
    steps = np.array([0, 3, 999], np.int32)
    if learned:
        p, apply = _flax(junet.RandomOrLearnedSinusoidalPosEmb(16), jnp.asarray(steps))
        m = _assign(tunet.RandomOrLearnedSinusoidalPosEmb(16), {"weights": p["weights"]})
    else:
        apply = lambda s: np.asarray(junet.SinusoidalPosEmb(16).apply({}, s))
        m = tunet.SinusoidalPosEmb(16)
    close(m(torch.from_numpy(steps).long()), apply(jnp.asarray(steps)), atol=1e-4)


def _block_values(p, name=""):
    return {f"{name}conv.weight": _oihw(p["WeightStandardizedConv_0"]["kernel"]),
            f"{name}conv.bias": p["WeightStandardizedConv_0"]["bias"],
            f"{name}norm.weight": p["GroupNorm_0"]["scale"],
            f"{name}norm.bias": p["GroupNorm_0"]["bias"]}


@pytest.mark.parametrize("film", [False, True])
def test_block(film):
    x = _rand(3, 2, 4, 4, 6)
    ss = (_rand(4, 2, 1, 1, 8, scale=0.3), _rand(5, 2, 1, 1, 8, scale=0.3)) if film else None
    jss = None if ss is None else tuple(jnp.asarray(a) for a in ss)
    p, apply = _flax(junet.Block(8, groups=2), jnp.asarray(x), jss)
    m = _assign(tunet.Block(6, 8, groups=2), _block_values(p))
    got = m(t(x), None if ss is None else tuple(t(a) for a in ss))
    close(got, apply(jnp.asarray(x), jss), **UNET_TOL)


@pytest.mark.parametrize("dims", [(6, 8), (8, 8)], ids=["res-conv", "identity"])
def test_resnet_block(dims):
    cin, cout = dims
    x, emb = _rand(6, 2, 4, 4, cin), _rand(7, 2, 12)
    p, apply = _flax(junet.ResnetBlock(cout, groups=2), jnp.asarray(x), jnp.asarray(emb))
    values = {"time_dense.weight": p["Dense_0"]["kernel"].T,
              "time_dense.bias": p["Dense_0"]["bias"],
              **_block_values(p["Block_0"], "block0."), **_block_values(p["Block_1"], "block1.")}
    if cin != cout:
        values.update({"res_conv.weight": _oihw(p["Conv_0"]["kernel"]),
                       "res_conv.bias": p["Conv_0"]["bias"]})
    m = _assign(tunet.ResnetBlock(cin, cout, 12, groups=2), values)
    close(m(t(x), t(emb)), apply(jnp.asarray(x), jnp.asarray(emb)), **UNET_TOL)


def _attention_values(p, linear, prefix=""):
    values = {f"{prefix}w_qkv": _mat(p["Conv_0"]["kernel"]),
              f"{prefix}w_out": _mat(p["Conv_1"]["kernel"]),
              f"{prefix}b_out": p["Conv_1"]["bias"]}
    if linear:
        values[f"{prefix}g"] = p["ChannelLayerNorm_0"]["g"]
    return values


@pytest.mark.parametrize("fused", [False, True], ids=["xla", "pallas"])
def test_linear_attention(fused):
    x = _rand(8, 3, 3, 5, 12)
    p, apply = _flax(junet.LinearAttention(fused=fused), jnp.asarray(x))
    m = _assign(tunet.LinearAttention(12), _attention_values(p, linear=True))
    expected = apply(jnp.asarray(x))
    with torch.no_grad():
        close(m(t(x)), expected, **UNET_TOL)
    # with the module's parameters requiring grad the kernel route goes
    # through its autograd Function (gradients: test_torch_fla_grad.py)
    y = m(t(x))
    assert type(y.grad_fn).__name__ == "FusedLinearAttentionFunctionBackward"
    close(y, expected, **UNET_TOL)
    close(m(t(x), use_kernels=False), expected, **UNET_TOL)


def test_attention_and_prenorm_residual():
    x = _rand(9, 2, 4, 4, 16)
    p, apply = _flax(junet.PreNormResidual(junet.Attention()), jnp.asarray(x))
    values = {"norm.g": p["ChannelLayerNorm_0"]["g"],
              **_attention_values(p["fn"], linear=False, prefix="fn.")}
    m = _assign(tunet.PreNormResidual(16, tunet.Attention(16)), values)
    close(m(t(x)), apply(jnp.asarray(x)), **UNET_TOL)


@pytest.mark.parametrize("kind", ["down", "up"])
def test_down_and_upsample(kind):
    x = _rand(10, 2, 4, 4, 6)
    cls = junet.Downsample if kind == "down" else junet.Upsample
    p, apply = _flax(cls(5), jnp.asarray(x))
    m = (tunet.Downsample if kind == "down" else tunet.Upsample)(6, 5)
    _assign(m, {"conv.weight": _oihw(p["Conv_0"]["kernel"]), "conv.bias": p["Conv_0"]["bias"]})
    close(m(t(x)), apply(jnp.asarray(x)), **UNET_TOL)


# -- the whole UNet, through the strict converter ----------------------------

UNET_CASES = {
    "xla": dict(fused_attention=False),
    "pallas": dict(fused_attention=True),
    "learned-var-selfcond-fourier": dict(learned_variance=True, self_condition=True,
                                         learned_sinusoidal_cond=True),
}
IMG, CH = 8, 6


@pytest.fixture(scope="module", params=list(UNET_CASES))
def unet_pair(request):
    kw = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=2, channels=CH,
              **UNET_CASES[request.param])
    jmodel = junet.Unet(**kw)
    x0 = jnp.zeros((1, IMG, IMG, CH))
    tree = randomize(to_numpy_tree(jmodel.init(jax.random.PRNGKey(3), x0,
                                               jnp.zeros((1,), jnp.int32))["params"]), seed=4)
    kw.pop("fused_attention", None)
    tmodel = convert.unet_from_flax(tunet.Unet(**kw), tree)
    return jmodel, tree, tmodel


@pytest.mark.parametrize("time", ["per-sample", "length-1"])
def test_unet_matches_jax(unet_pair, time):
    jmodel, tree, tmodel = unet_pair
    x = _rand(11, 3, IMG, IMG, CH)
    steps = np.array([0, 17, 999], np.int32) if time == "per-sample" else np.array([5], np.int32)
    sc = _rand(12, 3, IMG, IMG, CH, scale=0.5) if jmodel.self_condition else None
    expected = np.asarray(jmodel.apply(
        {"params": jax.tree.map(jnp.asarray, tree)}, jnp.asarray(x), jnp.asarray(steps),
        None if sc is None else jnp.asarray(sc)))
    with torch.no_grad():
        got = tmodel(t(x), torch.from_numpy(steps).long(), None if sc is None else t(sc))
        plain = tmodel(t(x), torch.from_numpy(steps).long(), None if sc is None else t(sc),
                       use_kernels=False)
    assert got.shape == expected.shape
    close(got, expected, **UNET_TOL)
    close(plain, expected, **UNET_TOL)


def test_unet_to_flax_roundtrips(unet_pair):
    _, tree, tmodel = unet_pair
    back = convert.unet_to_flax(tmodel)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def _tiny_tree():
    kw = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=2, channels=CH)
    shapes = jax.eval_shape(
        lambda: junet.Unet(**kw).init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, CH)),
                                      jnp.zeros((1,), jnp.int32)))["params"]
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    return kw, tree


def test_converter_refuses_missing_extra_and_misshapen_leaves():
    kw, tree = _tiny_tree()
    convert.unet_from_flax(tunet.Unet(**kw), tree)  # the complete tree fits

    missing = {k: v for k, v in tree.items() if k != "LinearAttention_1"}
    with pytest.raises(KeyError, match="missing leaves.*LinearAttention_1"):
        convert.unet_from_flax(tunet.Unet(**kw), missing)

    extra = dict(tree, Dense_2={"kernel": np.zeros((4, 4), np.float32)})
    with pytest.raises(KeyError, match="extra leaves.*Dense_2"):
        convert.unet_from_flax(tunet.Unet(**kw), extra)

    extra_leaf = dict(tree, Conv_0=dict(tree["Conv_0"], scale=np.zeros(8, np.float32)))
    with pytest.raises(KeyError, match="Conv_0/scale"):
        convert.unet_from_flax(tunet.Unet(**kw), extra_leaf)

    bad = dict(tree, Conv_3={"kernel": np.zeros((1, 1, 8, 5), np.float32),
                             "bias": np.zeros(5, np.float32)})
    with pytest.raises(ValueError, match="Conv_3/kernel"):
        convert.unet_from_flax(tunet.Unet(**kw), bad)

    # a tree of another architecture (learned variance: 2C outputs) does not fit
    with pytest.raises(ValueError):
        convert.unet_from_flax(tunet.Unet(learned_variance=True, **kw), tree)


def test_unported_options_raise():
    # a bf16 UNet is accepted (tests/test_torch_mixed_precision.py); a name
    # jnp.dtype would not read is refused as it refuses it
    unet = tunet.Unet(dim=8, dim_mults=(1, 2), resnet_block_groups=2, dtype="bfloat16")
    assert unet.dtype == torch.bfloat16 and unet.final_conv.dtype == torch.float32
    with pytest.raises(TypeError):
        tunet.Unet(dim=8, dim_mults=(1, 2), resnet_block_groups=2, dtype="bf")
