"""bf16 mixed precision of nfdpm_tpu_torch against nfdpm_tpu on the CPU.

Two knobs, as in the JAX package: GlowConfig.coupling_dtype="bfloat16" (the
coupling CNN's two inner convolutions) and Unet(dtype="bfloat16") (the
UNet's convolutions, in two rounding kinds). CPU bf16 convolutions differ
from one implementation to the next by about 3e-3 of the largest output a
conv, so the port cannot be held to the JAX package's bf16 numbers much
more tightly than bf16's own rounding. These tests therefore prove that the
port rounds at the same points as the JAX package by counting: the
multiset of (kernel shape HWIO, compute dtype, dtype of the add that takes
the conv's output) over every convolution, from the jaxpr on the JAX side
(sub-jaxprs walked, a scan body counted once a step) and from a
TorchDispatchMode on aten.convolution and the adds after it on the port's.
Values are held to the JAX package's own bf16 bound, 5% of the largest
output (tests/test_diffusion.py:test_unet_bfloat16_dtype_knob); a 3-step
Adam trajectory to 1% of the bits/dim. Glow L2/K2, coupling width 32,
8x8x3; UNet dim 16, [1, 2].
"""

import collections
import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_port import (REPO_ROOT, jax_diffusion_draws, one_torch_thread, port_tree,
                         randomize, t, to_numpy_tree, write_jax_diffusion_run)
from nfdpm_tpu.models import glow as jglow
from nfdpm_tpu.models import prior as jprior
from nfdpm_tpu.models import unet as junet
from nfdpm_tpu.ops import coupling as jcoupling
from nfdpm_tpu.training import nf_trainer as jnft
from nfdpm_tpu.training import optim as joptim
import nfdpm_tpu_torch as port
from nfdpm_tpu_torch import convert
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.models import unet as tunet
from nfdpm_tpu_torch.ops import bijectors as tbj
from nfdpm_tpu_torch.ops import coupling as tcoupling
from nfdpm_tpu_torch.training import nf_trainer as tnft

sys.path.insert(0, str(REPO_ROOT / "tools"))
import jax_run_to_torch  # noqa: E402

IMG, BATCH = 8, 4
GLOW = dict(in_channels=3, levels=2, steps=2, coupling_width=32, learn_prior=True)
UNET = dict(dim=16, dim_mults=(1, 2), resnet_block_groups=8, channels=3)
BF16_BOUND = 0.05  # of the largest output: tests/test_diffusion.py's bf16 bound
ADAM_STEPS, ADAM_TOL = 3, 0.01  # bits/dim within 1% each step


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def within_bound(got, want, bound=BF16_BOUND):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = float(np.max(np.abs(want)))
    gap = float(np.max(np.abs(got - want)))
    assert gap <= bound * scale, (gap, scale)
    return gap / scale


# -- counting the rounding points ----------------------------------------------

_JAX_PASS = {"convert_element_type", "reshape", "transpose", "squeeze", "copy"}


def jax_convs(closed, leaf_paths=None, exclude=()):
    """Counter of (kernel shape, compute dtype, add dtype) over every
    conv_general_dilated of a closed jaxpr, sub-jaxprs included (a scan
    body's convs count `length` times). The add dtype is that of the first
    add that takes the conv's output, through casts and relayouts. A conv
    whose kernel depends on a top-level input whose path (`leaf_paths`, one
    string per input) holds one of `exclude` is left out."""
    found = collections.Counter()

    def walk(jaxpr, mult, deps_of):
        pending, records = {}, []
        deps = dict(deps_of)
        for e in jaxpr.eqns:
            ins = [v for v in e.invars if type(v).__name__ != "Literal"]
            dep = set().union(*(deps.get(v, set()) for v in ins))
            for v in e.outvars:
                deps[v] = dep
            name = e.primitive.name
            if name == "conv_general_dilated":
                rhs = e.invars[1]
                paths = {leaf_paths[i] for i in deps.get(rhs, ())} if leaf_paths else set()
                rec = [tuple(rhs.aval.shape), str(e.invars[0].aval.dtype), None, mult,
                       any(x in p for p in paths for x in exclude)]
                records.append(rec)
                pending[e.outvars[0]] = rec
            elif name in _JAX_PASS and ins and ins[0] in pending:
                pending[e.outvars[0]] = pending[ins[0]]
            elif name == "add":
                for v in ins:
                    if v in pending and pending[v][2] is None:
                        pending[v][2] = str(e.outvars[0].aval.dtype)
            for key, sub in e.params.items():
                subs = sub if isinstance(sub, (tuple, list)) else (sub,)
                for s in subs:
                    inner = getattr(s, "jaxpr", s)
                    if not hasattr(inner, "eqns"):
                        continue
                    k = mult * (e.params["length"] if name == "scan" else 1)
                    walk(inner, k, {v: dep for v in inner.invars})
        for shape, dtype, add, k, excluded in records:
            if not excluded:
                assert add is not None, f"no add takes the output of the {shape} {dtype} conv"
                found[(shape, dtype, add)] += k

    walk(closed.jaxpr, 1, {v: {i} for i, v in enumerate(closed.jaxpr.invars)})
    return found


class ConvCounter(TorchDispatchMode):
    """The port's side: every aten.convolution as (kernel shape HWIO, input
    dtype, dtype of the bias add), the add being the convolution's own bias
    or the first aten.add that takes its output through casts and views;
    every matmul's dtype."""

    _PASS = {"permute", "view", "_unsafe_view", "_to_copy", "clone", "transpose", "t",
             "alias", "expand", "contiguous"}

    def __init__(self):
        super().__init__()
        self.records, self.matmuls, self._pending, self._keep = [], [], {}, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name == "convolution":
            x, w, b = args[:3]
            o, i, kh, kw = w.shape
            rec = [(kh, kw, i, o), str(x.dtype), None if b is None else str(out.dtype)]
            self.records.append(rec)
            if b is None:
                self._track(out, rec)
        elif name in self._PASS and isinstance(args[0], torch.Tensor) \
                and id(args[0]) in self._pending:
            self._track(out, self._pending[id(args[0])])
        elif name == "add":
            for a in args[:2]:
                rec = self._pending.get(id(a)) if isinstance(a, torch.Tensor) else None
                if rec is not None and rec[2] is None:
                    rec[2] = str(out.dtype)
        elif name in ("mm", "bmm", "addmm", "baddbmm"):
            self.matmuls.append(str(out.dtype))
        return out

    def _track(self, t_out, rec):
        self._keep.append(t_out)  # keeps the id unique while it is tracked
        self._pending[id(t_out)] = rec

    def counted(self):
        found = collections.Counter()
        for shape, dtype, add in self.records:
            assert add is not None, f"no add takes the output of the {shape} {dtype} conv"
            found[(shape, dtype.replace("torch.", ""), add.replace("torch.", ""))] += 1
        return found


def _count(fn):
    with ConvCounter() as counter:
        fn()
    return counter


# -- the Glow ----------------------------------------------------------------------

def _glow_tree(seed=3):
    cfg = jglow.GlowConfig(**GLOW)
    prior = jprior.init_gaussian_prior(tglow.final_channels(tglow.GlowConfig(**GLOW)), True)
    return randomize(to_numpy_tree({"flow": jglow.init_glow(0, cfg), "prior": prior}),
                     seed=seed)


def _images(seed=5):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, (BATCH, IMG, IMG, 3)).astype(
        np.float32)


def _cfgs(dtype="bfloat16", kernels=True, **kw):
    return (jglow.GlowConfig(coupling_dtype=dtype, use_pallas=kernels, **GLOW),
            tglow.GlowConfig(coupling_dtype=dtype, use_kernels=kernels, **GLOW, **kw))


@pytest.mark.parametrize("kernels", [True, False], ids=["kernel-route", "plain-route"])
@pytest.mark.parametrize("direction", ["forward", "inverse", "train-forward"])
def test_glow_rounds_where_jax_rounds(kernels, direction):
    """The same convolutions in the same dtypes, their outputs added to in
    the same dtypes: 2 bf16 convs (conv1, conv2) a step then fp32 adds (the
    actnorm epilogue), the zeroconvs and split priors fp32."""
    tree = _glow_tree()
    jcfg, tcfg = _cfgs(kernels=kernels)
    x = _images()
    flow = convert.from_jax_params(tree, "cpu")["flow"]
    if direction == "inverse":
        latents = [np.asarray(z) for z in jglow.forward(tree["flow"], jcfg, x)[0]]
        want = jax_convs(jax.make_jaxpr(lambda p, z: jglow.inverse(p, jcfg, z))(
            tree["flow"], latents))
        with torch.no_grad():
            got = _count(lambda: tglow.inverse(flow, tcfg, [t(z) for z in latents]))
    else:
        want = jax_convs(jax.make_jaxpr(lambda p, x: jglow.forward(p, jcfg, x))(
            tree["flow"], x))
        if direction == "forward":
            with torch.no_grad():
                got = _count(lambda: tglow.forward(flow, tcfg, t(x)))
        else:  # the train step's loss, with gradients wanted
            params = convert.trainable(convert.from_jax_params(tree, "cpu"))
            loss = tnft.make_loss_fn(tcfg, tnft.NFTrainConfig())
            noise = np.random.default_rng(6).random((BATCH, IMG, IMG, 3)).astype(np.float32)
            got = _count(lambda: loss(params, t(x + 0.5), noise=t(noise)))
    n_steps = GLOW["levels"] * GLOW["steps"]
    assert sum(n for (_, d, _), n in want.items() if d == "bfloat16") == 2 * n_steps
    assert all(a == "float32" for (_, _, a) in want)
    assert got.counted() == want


def test_remat_recomputes_in_bf16():
    """GlowConfig.remat: the backward pass runs each step's forward again,
    in bf16, and the gradients equal those kept without remat."""
    tree = _glow_tree()
    x = _images()
    noise = np.random.default_rng(6).random((BATCH, IMG, IMG, 3)).astype(np.float32)
    grads, counts = [], []
    for remat in (False, True):
        _, cfg = _cfgs(remat=remat)
        params = convert.trainable(convert.from_jax_params(tree, "cpu"))
        bpd, _ = tnft.make_loss_fn(cfg, tnft.NFTrainConfig())(params, t(x + 0.5),
                                                             noise=t(noise))
        counter = _count(bpd.backward)
        counts.append(collections.Counter(r[1] for r in counter.records))
        grads.append([p.grad for _, p in convert.named_leaves(params) if p.requires_grad])
    n_steps = GLOW["levels"] * GLOW["steps"]
    assert counts[0]["torch.bfloat16"] == 0  # backward convs are convolution_backward
    assert counts[1]["torch.bfloat16"] == 2 * n_steps  # the recomputed forwards
    assert counts[1]["torch.float32"] == n_steps  # their zeroconvs
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "co-trained"])
def test_backbone_carries_the_dtype(frozen):
    """The stage-2 backbone runs its GlowConfig's dtype, frozen or co-trained."""
    from nfdpm_tpu_torch.models.nf_backbone import NFBackbone

    _, cfg = _cfgs()
    flow = convert.from_jax_params(_glow_tree(), "cpu")["flow"]
    if not frozen:
        flow = convert.trainable({"flow": flow})["flow"]
    backbone = NFBackbone(cfg, IMG, frozen=frozen)
    counter = _count(lambda: backbone.transform(flow, t(_images())))
    n_steps = GLOW["levels"] * GLOW["steps"]
    dtypes = collections.Counter(r[1] for r in counter.records)
    assert dtypes == {"torch.bfloat16": 2 * n_steps, "torch.float32": n_steps}


def test_coupling_net_matches_jax_bf16():
    net = randomize(to_numpy_tree(jcoupling.init_coupling_net(
        np.random.default_rng(0), 6, 32, 12)), seed=1)
    x = _rand(2, BATCH, IMG, IMG, 6)
    want = np.asarray(jcoupling.coupling_net_apply(net, jnp.asarray(x), jnp.bfloat16))
    tnet = port_tree(net)
    got = tcoupling.coupling_net_apply(tnet, t(x), torch.bfloat16)
    fp32 = tcoupling.coupling_net_apply(tnet, t(x))
    assert got.dtype == torch.float32
    within_bound(got, want)
    assert not torch.equal(got, fp32)  # bf16 ran
    # the step tails' operand: the raw zeroconv output, fp32
    r = tcoupling.coupling_net_conv(tnet, t(x), torch.bfloat16)
    assert r.dtype == torch.float32


@pytest.mark.parametrize("kernels", [True, False], ids=["kernel-route", "plain-route"])
def test_glow_latents_and_logdet_match_jax_bf16(kernels):
    tree = _glow_tree()
    jcfg, tcfg = _cfgs(kernels=kernels)
    x = _images()
    jl, jldj, jlogp = jglow.forward(tree["flow"], jcfg, x)
    flow = convert.from_jax_params(tree, "cpu")["flow"]
    with torch.no_grad():
        tl, tldj, tlogp = tglow.forward(flow, tcfg, t(x))
        fl, fldj, _ = tglow.forward(flow, dataclasses.replace(tcfg, coupling_dtype="float32"),
                                    t(x))
        back = tglow.inverse(flow, tcfg, tl)
    for a, b in zip(tl, jl):
        assert a.dtype == torch.float32
        within_bound(a, b)
    within_bound(tldj, jldj)
    within_bound(tlogp, jlogp)
    assert not all(torch.equal(a, b) for a, b in zip(tl, fl))
    # a step's inverse evaluates its forward's bf16 function; down the chain
    # fp32 roundoff can flip a bf16 rounding of a CNN input (at this size
    # the whole flow still comes back within the fp32 bound)
    assert float((back - t(x)).abs().max()) < 2e-3


def test_unknown_coupling_dtype_is_fp32_as_in_jax():
    assert tglow.GlowConfig(coupling_dtype="bfloat16").compute_dtype == torch.bfloat16
    for name in ("float32", "float16", "bogus"):
        assert tglow.GlowConfig(coupling_dtype=name).compute_dtype == torch.float32
        assert jglow.GlowConfig(coupling_dtype=name)._coupling_jnp_dtype == jnp.float32


@pytest.mark.parametrize("remat", [False, True], ids=["kept", "remat"])
def test_glow_gradients_are_finite_fp32_on_every_leaf(remat):
    tree = _glow_tree()
    _, cfg = _cfgs(remat=remat)
    params = convert.trainable(convert.from_jax_params(tree, "cpu"))
    noise = np.random.default_rng(6).random((BATCH, IMG, IMG, 3)).astype(np.float32)
    bpd, _ = tnft.make_loss_fn(cfg, tnft.NFTrainConfig())(params, t(_images() + 0.5),
                                                         noise=t(noise))
    bpd.backward()
    leaves = [(k, p) for k, p in convert.named_leaves(params) if p.requires_grad]
    assert len(leaves) > 50
    for k, p in leaves:
        assert p.dtype == p.grad.dtype == torch.float32, k
        assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, k


def test_adam_trajectory_matches_jax_bf16():
    """Three Adam steps of the bf16 flow from one ddinit'ed state and the
    same dequantization noise: the JAX train step (Pallas route, interpret
    mode) against the port's (kernel route); bits/dim within 1% each step."""
    jcfg, tcfg = _cfgs()
    tree = _glow_tree(seed=7)
    rng = np.random.default_rng(11)
    imgs = rng.integers(0, 256, (ADAM_STEPS, BATCH, IMG, IMG, 3)).astype(np.float32) / 255.0
    noise = rng.random(imgs.shape).astype(np.float32)
    tree["flow"] = to_numpy_tree(jglow.ddinit(jax.tree.map(jnp.asarray, tree["flow"]), jcfg,
                                              jnp.asarray(imgs[0] - 0.5 + noise[0] / 32)))
    tx = joptim.make_optimizer("adam", 1e-3, fixed_prior=True)
    params = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": params, "opt_state": tx.init(params), "step": jnp.zeros((), jnp.int32)}
    jstep = jnft.make_train_step(jcfg, jnft.NFTrainConfig(lr=1e-3), tx, inject_noise=True)
    ttcfg = tnft.NFTrainConfig(lr=1e-3)
    ttx = tnft.optimizer_of(ttcfg)
    tparams = convert.trainable(convert.from_jax_params(tree, "cpu"))
    tstate = {"params": tparams, "opt_state": ttx.init(tparams), "step": 0}
    tstep = tnft.make_train_step(tcfg, ttcfg, ttx, inject_noise=True, device="cpu")
    for i in range(ADAM_STEPS):
        jstate, jm = jstep(jstate, jnp.asarray(imgs[i]), jnp.asarray(noise[i]))
        tstate, tm = tstep(tstate, imgs[i], noise[i])
        want, got = float(jm["bpd"]), float(tm["bpd"])
        assert np.isfinite(got) and abs(got - want) <= ADAM_TOL * abs(want), (i, got, want)
    for _, p in convert.named_leaves(tstate["params"]):
        assert p.dtype == torch.float32


def test_ddinit_and_the_megakernel_stay_fp32():
    """Whatever the dtype: the data-dependent init (glow.ddinit) and the
    whole-step megakernel's route run every convolution in fp32, and give
    what the fp32 configuration gives."""
    tree = _glow_tree()
    flow = convert.from_jax_params(tree, "cpu")["flow"]
    x = t(_images())
    _, bf16 = _cfgs()
    counter = _count(lambda: tglow.ddinit(flow, bf16, x))
    assert counter.records and all(r[1] == "torch.float32" for r in counter.records)
    a = tglow.ddinit(flow, bf16, x)
    b = tglow.ddinit(flow, dataclasses.replace(bf16, coupling_dtype="float32"), x)
    for (_, u), (_, v) in zip(convert.named_leaves(a), convert.named_leaves(b)):
        assert torch.equal(u, v)
    step = flow["blocks"][0]["steps"][0]
    y = tbj.squeeze_forward(x)
    ldj = torch.zeros(BATCH)
    with torch.no_grad():
        counter = _count(lambda: tbj.step_forward_megakernel(step, y, ldj))
        fp32 = tbj.step_forward(step, y, ldj, use_kernels=True)
        mega = tbj.step_forward_megakernel(step, y, ldj)
    assert counter.records and all(r[1] == "torch.float32" for r in counter.records)
    assert float((mega[0] - fp32[0]).abs().max()) < 1e-5


# -- the UNet -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def unet_tree():
    x0 = jnp.zeros((1, IMG, IMG, 3))
    return randomize(to_numpy_tree(junet.Unet(**UNET).init(
        jax.random.PRNGKey(3), x0, jnp.zeros((1,), jnp.int32))["params"]), seed=4)


def _unet_inputs():
    return _rand(11, 3, IMG, IMG, 3), np.array([0, 17, 999], np.int32)


def _port_unet(tree, dtype="bfloat16"):
    return convert.unet_from_flax(tunet.Unet(dtype=dtype, **UNET), tree)


def test_unet_rounds_where_jax_rounds(unet_tree):
    """Both rounding kinds: Block's weight-standardized convs in bf16 with
    the fp32 bias added after the upcast; flax nn.Conv(dtype=bf16) (init,
    residual, Down/Upsample, the last level's 3x3) with the bias added in
    bf16; the final 1x1 conv fp32. The attentions' 1x1 convs, which the
    port computes as fp32 matmuls, are left out of the JAX side and every
    matmul of the port is fp32."""
    x, steps = _unet_inputs()
    jmodel = junet.Unet(dtype=jnp.bfloat16, **UNET)
    params = jax.tree.map(jnp.asarray, unet_tree)
    closed = jax.make_jaxpr(lambda p, x, s: jmodel.apply({"params": p}, x, s, None))(
        params, jnp.asarray(x), jnp.asarray(steps))
    paths = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(
        params)[0]] + ["x", "t"]
    want = jax_convs(closed, paths, exclude=("Attention",))
    kinds = collections.Counter((d, a) for (_, d, a) in want.elements())
    assert kinds[("bfloat16", "float32")] and kinds[("bfloat16", "bfloat16")]
    assert kinds[("float32", "float32")] == 1  # the final 1x1 conv
    tmodel = _port_unet(unet_tree)
    for kernels in (True, False):
        with torch.no_grad():
            counter = _count(lambda: tmodel(t(x), torch.from_numpy(steps).long(),
                                            use_kernels=kernels))
        assert counter.counted() == want
        assert counter.matmuls and set(counter.matmuls) == {"torch.float32"}


def test_unet_modules_match_jax_bf16():
    """One Block and one ResnetBlock (with its 1x1 residual conv) against
    the JAX package's bf16 modules, within 5% of the largest output."""
    x, emb = _rand(6, 2, 4, 4, 6), _rand(7, 2, 12)
    block = junet.Block(8, groups=2, dtype=jnp.bfloat16)
    bp = randomize(to_numpy_tree(block.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]),
                   seed=1)
    res = junet.ResnetBlock(8, groups=2, dtype=jnp.bfloat16)
    rp = randomize(to_numpy_tree(res.init(jax.random.PRNGKey(2), jnp.asarray(x),
                                          jnp.asarray(emb))["params"]), seed=3)

    def block_values(p, name=""):
        return {f"{name}conv.weight": np.asarray(p["WeightStandardizedConv_0"]["kernel"]
                                                 ).transpose(3, 2, 0, 1),
                f"{name}conv.bias": p["WeightStandardizedConv_0"]["bias"],
                f"{name}norm.weight": p["GroupNorm_0"]["scale"],
                f"{name}norm.bias": p["GroupNorm_0"]["bias"]}

    def assign(module, values):
        with torch.no_grad():
            for name, p in module.named_parameters():
                p.copy_(torch.from_numpy(np.ascontiguousarray(values[name])))
        return module

    tblock = assign(tunet.Block(6, 8, groups=2, dtype=torch.bfloat16), block_values(bp))
    tres = assign(tunet.ResnetBlock(6, 8, 12, groups=2, dtype=torch.bfloat16), {
        "time_dense.weight": rp["Dense_0"]["kernel"].T, "time_dense.bias": rp["Dense_0"]["bias"],
        **block_values(rp["Block_0"], "block0."), **block_values(rp["Block_1"], "block1."),
        "res_conv.weight": np.asarray(rp["Conv_0"]["kernel"]).transpose(3, 2, 0, 1),
        "res_conv.bias": rp["Conv_0"]["bias"]})
    with torch.no_grad():
        got_b, got_r = tblock(t(x)), tres(t(x), t(emb))
    assert got_b.dtype == got_r.dtype == torch.float32
    within_bound(got_b, block.apply({"params": bp}, jnp.asarray(x)))
    within_bound(got_r, res.apply({"params": rp}, jnp.asarray(x), jnp.asarray(emb)))


def test_unet_matches_jax_bf16(unet_tree):
    x, steps = _unet_inputs()
    want = np.asarray(junet.Unet(dtype=jnp.bfloat16, **UNET).apply(
        {"params": jax.tree.map(jnp.asarray, unet_tree)}, jnp.asarray(x), jnp.asarray(steps),
        None))
    bf16, fp32 = _port_unet(unet_tree), _port_unet(unet_tree, "float32")
    assert bf16.dtype == torch.bfloat16 and fp32.dtype == torch.float32
    with torch.no_grad():
        ts = torch.from_numpy(steps).long()
        kernel, plain = bf16(t(x), ts), bf16(t(x), ts, use_kernels=False)
        full = fp32(t(x), ts)
    assert kernel.dtype == plain.dtype == torch.float32
    within_bound(kernel, want)
    within_bound(plain, want)
    assert not torch.equal(kernel, full)


@pytest.mark.parametrize("name", ["bfloat16", "float16", "float32", "bogus"])
def test_unet_dtype_names_as_jnp_dtype_reads_them(name):
    if name == "bogus":
        with pytest.raises(TypeError):
            jnp.dtype(name)
        with pytest.raises(TypeError):
            tunet.Unet(dtype=name, **UNET)
        return
    assert tunet.Unet(dtype=name, **UNET).dtype == getattr(torch, name)
    assert str(jnp.dtype(name)) == name


def test_unet_l1_gradients_are_finite_fp32(unet_tree):
    model = _port_unet(unet_tree).requires_grad_(True)
    x, steps = _unet_inputs()
    target = _rand(12, *x.shape)
    loss = (model(t(x), torch.from_numpy(steps).long()) - t(target)).abs().mean()
    loss.backward()
    for name, p in model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name
        assert p.grad.abs().max() > 0, name


# -- a converted bf16 stage-2 run ---------------------------------------------------

def test_a_bf16_stage_2_jax_run_converts_and_resumes(tmp_path):
    """tools/jax_run_to_torch.py on a JAX stage-2 run whose UNets are bf16:
    the dtype string passes through diffusion_architecture.json, the port
    rebuilds bf16 UNets from the same trees, and two resumed train steps
    with the JAX step's draws give its l1 losses within 1%."""
    from nfdpm_tpu.training import diffusion_trainer as jdt
    from nfdpm_tpu.training import runload as jrl
    from nfdpm_tpu_torch.training import diffusion_trainer as tdt
    from nfdpm_tpu_torch.training import runload as trl

    jax_dir, port_dir = tmp_path / "bf16_jax", tmp_path / "bf16_port"
    write_jax_diffusion_run(jax_dir, ema=False)
    arch_path = jax_dir / "diffusion_architecture.json"
    arch = json.loads(arch_path.read_text())
    arch["unet_kwargs"]["dtype"] = "bfloat16"
    arch_path.write_text(json.dumps(arch))

    jax_run_to_torch.main(["--run-dir", str(jax_dir), "--out", str(port_dir)])
    assert json.loads((port_dir / "diffusion_architecture.json").read_text())[
        "unet_kwargs"]["dtype"] == "bfloat16"
    jrun = jrl.load_diffusion_run(str(jax_dir), 1, use_ema=False)
    trun = trl.load_diffusion_run(str(port_dir), 1, use_ema=False, device="cpu")
    assert all(u.dtype == torch.bfloat16 for u in trun.params["diffusion"]["parts"])

    jstate = jax.tree.map(jnp.asarray, jax_run_to_torch.jax_train_state(
        str(jax_dir), "diffusion", 1))
    jtcfg = jdt.DiffusionTrainConfig()
    jstep = jdt.make_train_step(jrun.backbone, jrun.dp, jtcfg,
                                jdt.make_two_group_optimizer(jtcfg, True))
    tstate = tdt.restore_train_state(str(port_dir), 1, trun.backbone, trun.dp, want_ema=False,
                                     device="cpu")
    tcfg = tdt.DiffusionTrainConfig()
    tstep = tdt.make_train_step(trun.backbone, trun.dp, tcfg,
                                tdt.make_two_group_optimizer(tcfg, True), inject_noise=True,
                                device="cpu")
    imgs = np.random.default_rng(5).integers(0, 256, (2, 4, IMG, IMG, 3)).astype(
        np.float32) / 255.0
    key = jax.random.PRNGKey(11)
    shapes = [(4, *s) for s in jrun.dp.formater.input_shapes]
    for i in range(2):
        draws = jax_diffusion_draws(key, int(jstate["step"]), jrun.dp, shapes, imgs[i].shape)
        jstate, jm = jstep(jstate, jnp.asarray(imgs[i]), key)
        tstate, tm = tstep(tstate, imgs[i], draws)
        want, got = float(jm["loss"]), float(tm["loss"])
        assert np.isfinite(got) and abs(got - want) <= 0.01 * abs(want), (i, got, want)


# -- model.training.matmul_precision -------------------------------------------------

@pytest.mark.parametrize("value,tf32", [(None, False), ("default", False), ("highest", False),
                                        ("high", True), ("bogus", None)])
def test_matmul_precision_maps_to_the_tf32_switches(value, tf32):
    before = port.matmul_precision()
    try:
        if tf32 is None:
            with pytest.raises(ValueError, match="matmul_precision"):
                port.set_matmul_precision(value)
            return
        port.set_matmul_precision(value)
        assert port.matmul_precision() == value
        assert torch.backends.cudnn.allow_tf32 is tf32
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        port.apply_matmul_precision()  # what the model paths call
        assert torch.backends.cudnn.allow_tf32 is tf32
    finally:
        port.set_matmul_precision(before)
