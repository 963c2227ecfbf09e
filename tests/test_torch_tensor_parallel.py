"""The model axis (tensor parallelism) of nfdpm_tpu_torch against nfdpm_tpu
on the CPU: the mesh, the placements, the layers.

  * The ("data", "model") mesh: each rank's data and model index and its
    groups' members are the JAX package's make_mesh device array at
    (1, 2), (2, 2) and (2, 2) over 2 slices; the refusals of an n_model
    that does not divide the world and of n_data % n_slices.
  * The placements: the "model" placements equal the JAX specs leaf for
    leaf (Glow and UNet), each rank's slabs tile every leaf, also under
    fsdp_data = 2 (a data slab of the model slab, its spec the JAX
    package's composed one); a rank's parameter count at n_model 2 and 4.
  * Two gloo ranks at (data 1, model 2), one launch
    (tests/_torch_tp_scenarios.py:layers): the coupling net's forward,
    inverse and gradients against JAX, its bf16 output against the port at
    one rank (the mixed-precision gate), its data-dependent init; a small
    Glow's forward, inverse and ddinit on both step routes; the UNet's
    output and loss gradient (WSConv statistics summed over the model
    group, GroupNorm on whole groups) against the JAX package's
    test_unet_tp_matches_single_device model; a GroupNorm that does not
    split into whole groups raises.
Bounds: the JAX package's (tests/test_parallel.py: rtol 3e-4 / atol 1e-5;
its inverse-under-TP bound atol 2e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from types import SimpleNamespace

from jax.sharding import PartitionSpec

from _torch_port import one_torch_thread, randomize, run_ranks, to_numpy_tree
from nfdpm_tpu.models import glow as jglow
from nfdpm_tpu.models import prior as jprior
from nfdpm_tpu.models.unet import Unet as JUnet
from nfdpm_tpu.ops import bijectors as jbj
from nfdpm_tpu.ops import coupling as jcoupling
from nfdpm_tpu.parallel import mesh as jmesh
from nfdpm_tpu.parallel import sharding_rules as jrules
from nfdpm_tpu_torch import convert
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.models.unet import Unet as TUnet
from nfdpm_tpu_torch.models.unet import ResnetBlock as TResnetBlock
from nfdpm_tpu_torch.models.unet import init_unet_, shard_unet_
from nfdpm_tpu_torch.ops import coupling as tcoupling
from nfdpm_tpu_torch.parallel import mesh as tmesh
from nfdpm_tpu_torch.parallel import sharding_rules as trules
from nfdpm_tpu_torch.parallel.tensor_parallel import ModelAxis

GLOW = dict(in_channels=3, levels=2, steps=2, coupling_width=16, learn_prior=True)
UNET_TP = dict(dim=16, dim_mults=(1, 2), resnet_block_groups=4)  # test_parallel.py's
RTOL, ATOL = 3e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_data,n_model,n_slices", [(1, 2, 1), (2, 2, 1), (2, 2, 2)])
def test_mesh_layout_is_the_jax_device_order(n_data, n_model, n_slices):
    """Rank r at data index r // n_model, model index r % n_model: the JAX
    mesh's device array, with device id r as rank r; the model and data
    groups are its rows and columns."""
    devices = jmesh.make_mesh(n_data=n_data, n_model=n_model, n_slices=n_slices).devices
    ids = np.vectorize(lambda dev: dev.id)(devices)
    world = n_data * n_model
    models, datas = tmesh.axis_blocks(world, n_model)
    for r in range(world):
        m = tmesh.Mesh(world=world, rank=r, group=None, devices=(torch.device("cpu"),),
                       n_slices=n_slices, n_model=n_model)
        assert ids[m.data_rank, m.model_rank] == r
        assert m.shape == {"data": n_data, "model": n_model}
        assert models[m.data_rank] == list(ids[m.data_rank])
        assert datas[m.model_rank] == list(ids[:, m.model_rank])
    # a model group lies inside one slice: slices are contiguous rank blocks
    per_slice = world // n_slices
    for block in models:
        assert len({r // per_slice for r in block}) == 1


def test_make_mesh_refusals():
    mesh = tmesh.make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.model is None
    with pytest.raises(ValueError, match="n_model=2 does not divide the 1 processes"):
        tmesh.make_mesh(n_model=2, device="cpu")
    with pytest.raises(ValueError, match="n_model=2 does not divide the 3 processes"):
        tmesh.mesh_over([0, 1, 2], n_model=2, device="cpu")
    with pytest.raises(ValueError, match="divisible by n_slices"):
        tmesh.mesh_over([0, 1, 2, 3, 4, 5], n_model=2, n_slices=2, device="cpu")
    with pytest.raises(ValueError, match="not 3"):
        tmesh.mesh_over([0, 1, 2, 3], n_model=2, n_data=3, device="cpu")


# ---------------------------------------------------------------------------
# The placements
# ---------------------------------------------------------------------------

def _named(tree, names=(), is_leaf=lambda x: False):
    if is_leaf(tree):
        return {"/".join(names): tree}
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _named(sub, names + (str(key),), is_leaf).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _named(sub, names + (str(i),), is_leaf).items()}
    return {} if tree is None else {"/".join(names): tree}


def _jax_specs(specs):
    return {k: tuple(v) for k, v in _named(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec)).items()}


def _port_specs(specs):
    return {k: tuple(v) for k, v in _named(
        specs, is_leaf=lambda x: isinstance(x, trules.Spec)).items()}


def _port_path(jax_path, k=None):
    """A JAX-layout Glow path (K-stacked) -> the port's path of step k."""
    parts = jax_path.split("/")
    if "steps" in parts or "final_steps" in parts:
        i = parts.index("steps") if "steps" in parts else parts.index("final_steps")
        parts.insert(i + 1, str(k))
    return "flow/" + "/".join(parts)


def _tile_check(placements, leaves, n):
    for path, pl in placements.items():
        t = leaves[path]
        assert sum(pl.slab(t, r).numel() for r in range(n)) == t.numel(), path


@pytest.mark.parametrize("width", [16, 512])
def test_glow_model_placements_are_the_jax_specs(width):
    glow = dict(GLOW, levels=3, steps=4, coupling_width=width)
    shapes = jax.eval_shape(lambda: jglow.init_glow(0, jglow.GlowConfig(**glow)))
    want = _jax_specs(jrules.glow_param_specs(shapes))
    flow = tglow.init_glow(0, tglow.GlowConfig(**glow), "cpu")
    leaves = dict(convert.named_leaves({"flow": flow}))
    placements = trules.glow_model_placements(flow, 2)
    hwio_to_oihw = {0: 2, 1: 3, 2: 1, 3: 0}
    expected = {}
    for path, spec in want.items():
        if "model" not in spec:
            continue
        stacked = bool({"steps", "final_steps"} & set(path.split("/")))
        m = spec.index("model") - (1 if stacked else 0)
        for k in range(4 if stacked else 1):
            port = _port_path(path, k)
            expected[port] = hwio_to_oihw[m] if leaves[port].dim() == 4 else m
    assert {p: pl.dim for p, pl in placements.items()} == expected
    assert len(placements) == 5 * 12  # conv1, an1 (2), conv2, zconv a step
    for n in (2, 4):
        _tile_check(trules.glow_model_placements(flow, n), leaves, n)


def test_fsdp_data_slabs_of_model_slabs_are_the_composed_jax_specs():
    """fsdp_data = 2 under n_model = 2: the data placements computed on a
    rank's model slabs are the JAX package's composed specs, and the data
    slabs of the model slabs tile every leaf."""
    glow = dict(GLOW, levels=3, steps=4, coupling_width=16)
    shapes = jax.eval_shape(lambda: jglow.init_glow(0, jglow.GlowConfig(**glow)))
    want = _jax_specs(jrules.glow_param_specs(shapes, fsdp_data=2, fsdp_min_size=256))
    flow = tglow.init_glow(0, tglow.GlowConfig(**glow), "cpu")
    model_pl = trules.glow_model_placements(flow, 2, "flow")
    whole = dict(convert.named_leaves({"flow": flow}))
    for rank in range(2):
        mine = {p: (model_pl[p].slab(t, rank) if p in model_pl else t) for p, t in whole.items()}
        slab_flow = trules.replace_leaves({"flow": flow}, mine)["flow"]
        got = _port_specs(trules.glow_param_specs(trules._whole_shapes(
            trules.glow_jax_shapes(slab_flow), trules._spec_for, 2), fsdp_data=2,
            fsdp_min_size=256))
        assert got == want
        data_pl = trules.glow_placements(slab_flow, 2, "flow", fsdp_min_size=256, n_model=2)
        assert data_pl
        for path, pl in data_pl.items():
            if path in model_pl and pl.dim is not None:
                assert pl.dim != model_pl[path].dim, path
        _tile_check(data_pl, mine, 2)


def test_unet_model_placements_are_the_jax_specs():
    from nfdpm_tpu_torch.convert import _unet_layout

    unet = TUnet(channels=3, **UNET_TP)
    jparams = jax.eval_shape(lambda: JUnet(channels=3, **UNET_TP).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,), jnp.int32)))["params"]
    want = _jax_specs(jrules.unet_param_specs(jparams))
    placements = trules.unet_model_placements(unet, 2)
    axes = {"conv": {0: 2, 1: 3, 2: 1, 3: 0}, "dense": {0: 1, 1: 0}, "mat": {2: 0, 3: 1}}
    expected = {}
    for path, (name, kind) in _unet_layout(unet).items():
        spec = want[path]
        if "model" in spec:
            m = spec.index("model")
            expected[name] = axes.get(kind, {}).get(m, m)
    assert {n: pl.dim for n, pl in placements.items()} == expected
    assert any("w_qkv" in n for n in placements) and any("block1.conv" in n for n in placements)
    _tile_check(placements, dict(unet.named_parameters()), 2)


def test_a_ranks_parameter_count_at_full_width():
    """The default flow (L3/K4/w512) and a UNet of dim 64, dim_mults (1, 2),
    8 groups: the model-sharded leaves and what a rank holds."""
    flow = tglow.init_glow(0, tglow.GlowConfig(), "cpu")
    leaves = dict(convert.named_leaves({"flow": flow}))
    total = sum(t.numel() for t in leaves.values())
    for n, held in ((2, 2_794_128), (4, 1_424_016)):
        placements = trules.glow_model_placements(flow, n)
        assert sum(leaves[p].numel() for p in placements) == 5_480_448
        assert len(placements) == 60 and total == 5_534_352
        assert trules.predicted_param_bytes({"flow": flow}, placements, n - 1) == 4 * held
    # the Adam moments of {"flow", "prior"} a rank at (data 1, model 2), and
    # at (data 2, model 2) with ZeRO over the data axis
    from nfdpm_tpu_torch.models import prior as tprior
    from nfdpm_tpu_torch.parallel import tensor_parallel as tp
    from nfdpm_tpu_torch.training import nf_trainer as tnft

    params = {"flow": flow, "prior": tprior.init_gaussian_prior(48, True, "cpu")}
    mesh = SimpleNamespace(n_data=2, n_model=2, spatial=False)
    placements = trules.model_placements(mesh, params)
    for model_rank in (0, 1):
        assert 2 * trules.predicted_param_bytes(params, placements, model_rank) == 22_354_560
        mine = tp.shard_tree(ModelAxis(n=2, index=model_rank, group=None), params, placements)
        zero = tnft.nf_placements(mesh, mine, True)
        assert len(zero) == 36
        assert [trules.predicted_moment_bytes(mine, zero, r) for r in (0, 1)] == [11_418_240] * 2
    unet = TUnet(channels=6, dim=64, dim_mults=(1, 2), resnet_block_groups=8)
    named = dict(unet.named_parameters())
    placements = trules.unet_model_placements(unet, 2)
    assert len(placements) == 59
    assert sum(named[p].numel() for p in placements) == 2_054_976


def test_groupnorm_that_does_not_split_into_whole_groups_raises():
    """A GroupNorm whose groups do not split whole over the model axis is
    accepted (each group's statistics are taken over the model group,
    models/unet.GroupNorm; its values: tests/test_torch_split_groupnorm.py):
    the norms hold the rank's channels, the whole group count, the axis.
    A width that does not divide still raises."""
    unet = init_unet_(TUnet(channels=3, dim=8, dim_mults=(1, 2), resnet_block_groups=2), 0)
    axis = ModelAxis(n=4, index=1, group=None)
    shard_unet_(unet, axis)
    norms = [m.block0.norm for m in unet.modules() if isinstance(m, TResnetBlock)]
    assert norms and all(n.axis is axis and n.num_groups == 2 for n in norms)
    assert all(n.weight.shape[0] * 4 == n.num_channels for n in norms)
    with pytest.raises(ValueError, match="does not split"):
        trules.Placement(3, dim=0).slab(torch.zeros(4), 0)


# ---------------------------------------------------------------------------
# Two gloo ranks at (data 1, model 2)
# ---------------------------------------------------------------------------

def _coupling_inputs(rng):
    net = jcoupling.init_coupling_net(np.random.default_rng(3), 6, 16, 12)
    net = randomize(to_numpy_tree(net), seed=4, scale=0.1)
    x = rng.standard_normal((4, 8, 8, 12)).astype(np.float32)
    return net, x, rng.standard_normal(x.shape).astype(np.float32)


@pytest.fixture(scope="module")
def layers(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_layers")
    rng = np.random.default_rng(0)
    net, x, weights = _coupling_inputs(rng)
    glow_tree = randomize(to_numpy_tree({
        "flow": jglow.init_glow(0, jglow.GlowConfig(**GLOW)),
        "prior": jprior.init_gaussian_prior(24, True)}), seed=1)
    convert.save_npz(d / "glow_tree.npz", glow_tree)
    junet = JUnet(channels=3, **UNET_TP)
    ux = rng.standard_normal((8, 8, 8, 3)).astype(np.float32)
    ut = rng.integers(0, 10, (8,)).astype(np.int64)
    uparams = randomize(to_numpy_tree(jax.jit(junet.init)(
        jax.random.PRNGKey(1), jnp.asarray(ux), jnp.asarray(ut))["params"]), seed=2, scale=0.02)
    convert.save_npz(d / "unet_tree.npz", uparams)
    flat = {f"net/{k}/{kk}": v for k, sub in net.items() for kk, v in sub.items()}
    np.savez(d / "layers.npz", x=x, weights=weights,
             glow_x=(rng.random((4, 8, 8, 3)) - 0.5).astype(np.float32),
             unet_x=ux, unet_t=ut,
             unet_target=rng.standard_normal((8, 8, 8, 3)).astype(np.float32), **flat)
    job = {"scenarios": ["layers"], "n_model": 2, "glow": GLOW, "unet_tp": UNET_TP}
    out = run_ranks(job, 2, d)
    data = np.load(d / "layers.npz")
    return dict(out=[o["layers"] for o in out], net=net, data=data, glow_tree=glow_tree,
                junet=junet, uparams=uparams)


def _sub(out, prefix):
    return {k[len(prefix) + 1:]: v for k, v in out.items() if k.startswith(prefix + "/")}


def test_coupling_net_forward_inverse_and_gradient_match_jax(layers):
    net, data = layers["net"], layers["data"]
    x, weights = jnp.asarray(data["x"]), jnp.asarray(data["weights"])

    def loss(p, x):
        y, ldj = jbj.coupling_forward({"net": p}, x, jnp.zeros((x.shape[0],)))
        return jnp.sum(y * weights) + jnp.sum(ldj), (y, ldj)

    (_, (y, ldj)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, net), x)
    r = jcoupling.coupling_net_apply(jax.tree.map(jnp.asarray, net), x[..., :6])
    r_conv = (r / jnp.exp(3.0 * net["zconv"]["logs"])) - net["zconv"]["b"]
    gp = to_numpy_tree(gp)
    for out in layers["out"]:
        np.testing.assert_allclose(out["coupling/y"], y, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out["coupling/ldj"], ldj, rtol=1e-5)
        np.testing.assert_allclose(out["coupling/inverse"], data["x"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(out["coupling/r"], r_conv, rtol=RTOL, atol=1e-4)
        np.testing.assert_allclose(out["coupling/dx"], gx, rtol=RTOL, atol=1e-4)
        grads = _sub(out, "coupling/grad")
        assert len(grads) == 9
        for key, g in grads.items():
            k, kk = key.split("/")
            want = gp[k][kk]
            if kk == "w":
                want = want.transpose(3, 2, 0, 1)
            np.testing.assert_allclose(g, want, rtol=RTOL, atol=1e-4, err_msg=key)
    np.testing.assert_array_equal(layers["out"][0]["coupling/y"], layers["out"][1]["coupling/y"])


def test_coupling_net_bf16_and_ddinit_match_one_rank(layers):
    """bf16 at model 2 against the port's bf16 at one rank, within the
    mixed-precision gate (5% of the largest output); the data-dependent
    init's actnorms (an1 per channel of a slab, an2 after the sum) and
    output against one rank."""
    net = {k: {kk: torch.from_numpy(np.ascontiguousarray(v.transpose(3, 2, 0, 1)) if kk == "w"
                                    else v) for kk, v in sub.items()}
           for k, sub in layers["net"].items()}
    xa = torch.from_numpy(layers["data"]["x"][..., :6])
    with torch.no_grad():
        bf16 = tcoupling.coupling_net_apply(net, xa, torch.bfloat16).numpy()
        new, ddout = tcoupling.coupling_net_ddinit(net, xa)
    for out in layers["out"]:
        gate = 0.05 * np.abs(bf16).max()
        assert np.abs(out["coupling/bf16"] - bf16).max() <= gate
        np.testing.assert_allclose(out["coupling/ddinit_out"], ddout.numpy(), rtol=RTOL,
                                   atol=ATOL)
        for k in ("an1", "an2"):
            for kk in ("scale", "bias"):
                np.testing.assert_allclose(out[f"coupling/ddinit/{k}/{kk}"],
                                           new[k][kk].numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_kernels", [0, 1])
def test_glow_forward_inverse_and_ddinit_match_jax(layers, use_kernels):
    cfg = jglow.GlowConfig(**GLOW)
    params = jax.tree.map(jnp.asarray, layers["glow_tree"])
    x = jnp.asarray(layers["data"]["glow_x"])
    latents, ldj, logp = jglow.forward(params["flow"], cfg, x)
    jdd = to_numpy_tree(jglow.ddinit(params["flow"], cfg, x))
    want_dd = {}
    convert._flatten({"flow": jdd}, "", want_dd)
    for out in layers["out"]:
        tag = f"glow_k{use_kernels}"
        np.testing.assert_allclose(out[f"{tag}/ldj"], ldj, rtol=1e-5)
        np.testing.assert_allclose(out[f"{tag}/logp"], logp, rtol=1e-5)
        for i, z in enumerate(latents):
            np.testing.assert_allclose(out[f"{tag}/z{i}"], z, rtol=RTOL, atol=ATOL)
        # tests/test_parallel.py:193's bound for the inverse under TP
        np.testing.assert_allclose(out[f"{tag}/inverse"], x, atol=2e-3)
        got = _sub(out, f"{tag}/ddinit")
        assert got.keys() >= {k for k in want_dd if k.startswith("flow/")}
        for k in want_dd:
            if k.startswith("flow/"):
                np.testing.assert_allclose(got[k], want_dd[k], rtol=RTOL, atol=1e-4, err_msg=k)


def test_unet_output_and_loss_gradient_match_jax(layers):
    """test_unet_tp_matches_single_device's UNet (dim 16, 4 groups): output
    and the gradient of an l2 loss, every leaf."""
    data = layers["data"]
    junet = layers["junet"]
    target = jnp.asarray(data["unet_target"])

    def loss(p):
        o = junet.apply({"params": p}, jnp.asarray(data["unet_x"]), jnp.asarray(data["unet_t"]))
        return jnp.mean((o - target) ** 2), o

    (l, o), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, layers["uparams"]))
    grads = dict(convert.unet_from_flax(TUnet(channels=3, **UNET_TP),
                                        to_numpy_tree(g)).named_parameters())
    for out in layers["out"]:
        np.testing.assert_allclose(out["unet/out"], o, rtol=RTOL, atol=1e-4)
        np.testing.assert_allclose(out["unet/loss"], l, rtol=1e-5)
        got = _sub(out, "unet/grad")
        assert got.keys() == grads.keys()
        for k, v in grads.items():
            scale = float(np.abs(v.detach().numpy()).max()) + 1e-12
            np.testing.assert_allclose(got[k] / scale, v.detach().numpy() / scale, rtol=0,
                                       atol=1e-4, err_msg=k)
