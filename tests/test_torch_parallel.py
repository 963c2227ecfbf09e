"""Data parallelism of nfdpm_tpu_torch against nfdpm_tpu on the CPU.

The rules (the JAX package's PartitionSpecs leaf for leaf, host_shard,
the mesh's checks, the draws of a rank), then two gloo ranks
(tests/_torch_parallel_worker.py, one launch for the module): stage-1 steps
with the injected global noise and with the step's own generator, fsdp off
and on; stage-2 steps, frozen and co-trained, fsdp off and on, with the
JAX package's draws injected; a cross-topology resume both ways; the samplers and FID features on rows
that do not divide over the ranks; the emergency save when a rank is gone.
Each is
held against the JAX step on a make_mesh(n_data=2) mesh and against the
port at one rank within the JAX package's data-parallel bound
(tests/test_parallel.py: rtol 3e-4, atol 1e-5; bits/dim within 1e-5). The
ranks' parameters are bitwise equal; each rank's moments of a partitioned
leaf have the shape of its slab. FSDP_MIN_SIZE is lowered to 256 elements
in the ranks so that the small models' leaves are partitioned at all.
Glow L2/K2, width 16, 8x8x3, batch 8; stage 2: UNets of dim 8 at 16x16
(batch 4: at 8x8 a one-token attention level gives Adam roundoff to
amplify, ROADMAP §3).
"""

import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from _torch_port import jax_diffusion_draws, one_torch_thread, randomize, run_ranks, to_numpy_tree
from nfdpm_tpu.data import pipeline as jpipe
from nfdpm_tpu.models import formaters as jfmt
from nfdpm_tpu.models import glow as jglow
from nfdpm_tpu.models import prior as jprior
from nfdpm_tpu.models.diffusion_prior import DiffusionPrior as JDiffusionPrior
from nfdpm_tpu.models.nf_backbone import NFBackbone as JBackbone
from nfdpm_tpu.parallel import mesh as jmesh
from nfdpm_tpu.parallel import sharding_rules as jrules
from nfdpm_tpu.training import diffusion_trainer as jdt
from nfdpm_tpu.training import nf_trainer as jnft
from nfdpm_tpu.training import optim as joptim
from nfdpm_tpu_torch import convert
from nfdpm_tpu_torch.data import pipeline as tpipe
from nfdpm_tpu_torch.models import formaters as tfmt
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.models.diffusion_prior import DiffusionPrior as TDiffusionPrior
from nfdpm_tpu_torch.ops import draws as tdraws
from nfdpm_tpu_torch.parallel import mesh as tmesh
from nfdpm_tpu_torch.parallel import sharding_rules as trules
from nfdpm_tpu_torch.training import nf_trainer as tnft

IMG, BATCH, IMG2, BATCH2 = 8, 8, 16, 4
GLOW = dict(in_channels=3, levels=2, steps=2, coupling_width=16, learn_prior=True)
GLOW2 = dict(steps=1, learn_prior=True)  # tests/test_torch_diffusion_train.py's flow
UNET = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=2)
DIFF = dict(timesteps=8, sampling_timesteps=4, loss_type="l1", beta_schedule="cosine")
STAGE2 = [dict(name="frozen", formater="IdentityFormater", frozen=True,
               tcfg=dict(lr_diffusion=1e-3)),
          dict(name="cotrained", formater="CatFormater", frozen=False,
               tcfg=dict(lr_diffusion=1e-3, lr_nf=3e-4))]
RTOL, ATOL, BPD_TOL = 3e-4, 1e-5, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _named(tree, names=(), is_leaf=lambda x: False):
    """{"/"-joined names: leaf} with a sequence index as its number."""
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


# ---------------------------------------------------------------------------
# The rules, leaf for leaf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fsdp_data", [1, 2, 4])
@pytest.mark.parametrize("width", [16, 512])
def test_glow_param_specs_match_jax(fsdp_data, width):
    glow = dict(GLOW, levels=3, steps=4, coupling_width=width)
    shapes = jax.eval_shape(lambda: jglow.init_glow(0, jglow.GlowConfig(**glow)))
    min_size = 256 if width == 16 else jrules.FSDP_MIN_SIZE
    want = _jax_specs(jrules.glow_param_specs(shapes, fsdp_data=fsdp_data,
                                              fsdp_min_size=min_size))
    flow = tglow.init_glow(0, tglow.GlowConfig(**glow), "cpu")
    got = _port_specs(trules.glow_param_specs(trules.glow_jax_shapes(flow),
                                              fsdp_data=fsdp_data, fsdp_min_size=min_size))
    assert got == want
    assert any("model" in s for s in got.values())
    assert any("data" in s for s in got.values()) == (fsdp_data > 1)
    # each "data" entry lands on a port leaf: its slabs tile the leaf
    placements = trules.glow_placements(flow, fsdp_data, fsdp_min_size=min_size)
    leaves = dict(convert.named_leaves({"flow": flow}))
    assert len(placements) == sum(
        (4 if "steps" in k else 1) for k, s in want.items() if "data" in s)
    for path, pl in placements.items():
        sizes = [pl.slab(leaves[path], r).numel() for r in range(fsdp_data)]
        assert sum(sizes) == leaves[path].numel()


@pytest.mark.parametrize("fsdp_data", [1, 2, 4])
def test_unet_param_specs_match_jax(fsdp_data):
    tdp = TDiffusionPrior(tfmt.IdentityFormater(L=3, in_channels=3, size=32),
                          dict(dim=64, dim_mults=(1, 2), resnet_block_groups=8), dict(DIFF))
    for unet in tdp.init_params(0, "cpu")["parts"]:
        flax_tree = convert.unet_to_flax(unet)
        want = _jax_specs(jrules.unet_param_specs(flax_tree, fsdp_data=fsdp_data))
        got = _port_specs(trules.unet_param_specs(trules.unet_jax_shapes(unet),
                                                  fsdp_data=fsdp_data))
        assert got == want and any("model" in s for s in got.values())
        placements = trules.unet_placements(unet, fsdp_data, "u")
        assert bool(placements) == (fsdp_data > 1)
        params = dict(unet.named_parameters())
        for path, pl in placements.items():
            p = params[path[2:]]
            assert sum(pl.slab(p, r).numel() for r in range(fsdp_data)) == p.numel()


@pytest.mark.parametrize("n_data", [1, 2, 4])
def test_generic_specs_and_add_fsdp_match_jax(n_data):
    prior = to_numpy_tree(jprior.init_gaussian_prior(48, True))
    assert _port_specs(trules.generic_param_specs(prior, fsdp_data=n_data, fsdp_min_size=8)) == \
        _jax_specs(jrules.generic_param_specs(prior, fsdp_data=n_data, fsdp_min_size=8))
    rng = np.random.default_rng(n_data)
    for _ in range(40):
        shape = tuple(int(d) for d in rng.choice([1, 2, 3, 4, 6, 8, 12, 64, 512],
                                                 size=rng.integers(1, 5)))
        spec = tuple(rng.choice([None, "model"]) if rng.random() < 0.3 else None
                     for _ in range(rng.integers(0, len(shape) + 1)))
        want = jrules._add_fsdp(PartitionSpec(*spec), shape, n_data, min_size=64)
        assert tuple(trules._add_fsdp(trules.Spec(*spec), shape, n_data, 64)) == tuple(want)


@pytest.mark.parametrize("n_hosts", [1, 2, 3, 4])
def test_host_shard_matches_jax(n_hosts):
    batch = np.arange(10 * 3).reshape(10, 3)
    for host in range(n_hosts):
        np.testing.assert_array_equal(tpipe.host_shard(batch, host, n_hosts),
                                      jpipe.host_shard(batch, host, n_hosts))


def test_mesh_checks_and_rows():
    mesh = tmesh.make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group is None
    # a model axis needs n_model processes a data index (tests of the model
    # axis: tests/test_torch_tensor_parallel.py)
    with pytest.raises(ValueError, match="n_model=2 does not divide the 1 processes"):
        tmesh.make_mesh(n_model=2, device="cpu")
    with pytest.raises(ValueError, match="divisible by n_slices"):
        tmesh.make_mesh(n_slices=2, device="cpu")
    with pytest.raises(ValueError, match="spans the 1 processes"):
        tmesh.make_mesh(n_data=2, device="cpu")
    two = tmesh.Mesh(world=2, rank=1, group=None, devices=(torch.device("cpu"),))
    assert tmesh.data_sharding(two, 8) == slice(4, 8)
    with pytest.raises(ValueError, match="does not split"):
        tmesh.data_sharding(two, 7)
    batch = np.arange(8)
    np.testing.assert_array_equal(tmesh.shard_batch(two, batch), [4, 5, 6, 7])
    np.testing.assert_array_equal(tmesh.shard_batch(two, batch, microbatches=2), [2, 3, 6, 7])
    assert tmesh.split_rows(two, 3) == (2, 3) and tmesh.split_rows(two, 1) == (0, 1)


@pytest.mark.parametrize("world", [2, 3])
def test_row_generator_keeps_the_global_draws_rows(world):
    """Every rank's draws are its rows of the one-device draw, whatever the
    shape's batch axis; a shared draw (the coin) is the one-device draw."""
    n = 6 * world
    whole = {
        "rand": torch.rand((n, 3), generator=torch.Generator().manual_seed(1)),
        "randn": torch.randn((4, n, 2), generator=torch.Generator().manual_seed(1)),
        "randint": torch.randint(0, 9, (n,), generator=torch.Generator().manual_seed(1)),
    }
    for r in range(world):
        rows = slice(r * 6, (r + 1) * 6)

        def gen():
            return tdraws.RowGenerator(torch.Generator().manual_seed(1), rows.start, rows.stop, n)

        assert torch.equal(tdraws.rand((6, 3), gen(), "cpu"), whole["rand"][rows])
        assert torch.equal(tdraws.randn((4, 6, 2), gen(), "cpu", batch_dim=1),
                           whole["randn"][:, rows])
        assert torch.equal(tdraws.randint(9, (6,), gen(), "cpu"), whole["randint"][rows])
        coin = tdraws.rand((), gen(), "cpu", batch_dim=None)
        assert torch.equal(coin, torch.rand((), generator=torch.Generator().manual_seed(1)))
    with pytest.raises(ValueError, match="rows"):
        tdraws.rand((5, 3), tdraws.RowGenerator(torch.Generator(), 0, 6, n), "cpu")


# ---------------------------------------------------------------------------
# Two gloo ranks
# ---------------------------------------------------------------------------

def _stage1_inputs():
    jcfg = jglow.GlowConfig(**GLOW)
    tree = {"flow": jglow.init_glow(0, jcfg),
            "prior": jprior.init_gaussian_prior(tglow.final_channels(tglow.GlowConfig(**GLOW)),
                                                True)}
    tree = randomize(to_numpy_tree(tree), seed=1)
    rng = np.random.default_rng(11)
    imgs = rng.integers(0, 256, (3, BATCH, IMG, IMG, 3)).astype(np.float32) / 255.0
    return tree, imgs, rng.random(imgs.shape).astype(np.float32)


def _stage2_inputs(conf):
    jformater = jfmt.get_formater(conf["formater"])(L=2, in_channels=3, size=IMG2)
    tdp = TDiffusionPrior(tfmt.get_formater(conf["formater"])(L=2, in_channels=3, size=IMG2),
                          dict(UNET), dict(DIFF))
    jdp = JDiffusionPrior(jformater, dict(UNET), dict(DIFF))
    unets = {"parts": tuple(convert.unet_to_flax(u) for u in tdp.init_params(2, "cpu")["parts"])}
    glow2 = jglow.GlowConfig(**dict(GLOW, **GLOW2))
    tree = randomize(to_numpy_tree({"flow": jglow.init_glow(0, glow2), "diffusion": unets}),
                     seed=3, scale=0.02)
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (2, BATCH2, IMG2, IMG2, 3)).astype(np.float32) / 255.0
    key = jax.random.PRNGKey(11)
    shapes = [(BATCH2, *s) for s in jformater.input_shapes]
    draws = [jax_diffusion_draws(key, i, jdp, shapes, (BATCH2, IMG2, IMG2, 3))
             for i in range(len(imgs))]
    return tree, imgs, key, draws, jdp, glow2


def _world1_run(d):
    """One epoch at one rank (the port, in this process): the checkpoint the
    ranks resume, and the uninterrupted two-epoch run to hold both resumes
    against."""
    cfg = tglow.GlowConfig(**GLOW)
    runs = {}
    for name, epochs in (("world1_run", 1), ("uninterrupted", 2)):
        tcfg = tnft.NFTrainConfig(epochs=epochs, lr=1e-3, print_freq=100,
                                  save_checkpoint_freq=100)
        runs[name] = tnft.train(cfg=cfg, tcfg=tcfg, loaders=_loaders(), run_dir=str(d / name),
                                logger=logging.getLogger("world1"), seed=0, img_size=IMG,
                                device="cpu")
    return cfg, runs


def _loaders():
    """Fresh loaders: a shuffled loader's order moves on with every pass, so
    runs compared with each other start from new ones."""
    return tpipe.read_dataset("synthetic", "", batch_size=BATCH, img_size=IMG, seed=0,
                              synthetic_fallback=True, synthetic_n=32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    tree, imgs, noise = _stage1_inputs()
    convert.save_npz(d / "stage1_tree.npz", tree)
    np.savez(d / "stage1.npz", imgs=imgs, noise=noise)
    stage2 = {}
    for conf in STAGE2:
        tree2, imgs2, key, draws, jdp, glow2 = _stage2_inputs(conf)
        convert.save_npz(d / f"stage2_{conf['name']}_tree.npz", tree2)
        flat = {"imgs": imgs2}
        for i, dr in enumerate(draws):
            flat[f"dequant_{i}"] = dr["dequant"]
            for j, part in enumerate(dr["parts"]):
                flat.update({f"t_{i}_{j}": part["t"], f"noise_{i}_{j}": part["noise"],
                             f"coin_{i}_{j}": np.asarray(part["self_cond"])})
        np.savez(d / f"stage2_{conf['name']}.npz", **flat)
        stage2[conf["name"]] = (tree2, imgs2, key, draws, jdp, glow2)
    cfg, runs = _world1_run(d)
    rng = np.random.default_rng(9)
    np.savez(d / "features.npz", images=rng.integers(0, 256, (13, IMG, IMG, 3), np.uint8),
             w=rng.standard_normal((3, 4)).astype(np.float32))
    job = {"scenarios": ["stage1", "stage2", "resume", "sampling", "features", "gone"],
           "fsdp_min_size": 256,
           "glow": GLOW, "glow2": GLOW2, "img2": IMG2, "unet": UNET, "diff": DIFF,
           "stage2": STAGE2}
    out = run_ranks(job, 2, d)
    return dict(d=d, tree=tree, imgs=imgs, noise=noise, stage2=stage2, out=out, cfg=cfg,
                runs=runs)


def _params_close(got, want, rtol=RTOL, atol=ATOL):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def _sub(out, prefix):
    return {k[len(prefix) + 1:]: v for k, v in out.items() if k.startswith(prefix + "/")}


def _flat(tree, prefix=""):
    """{path: a copy} (a CPU tensor's numpy view would follow later steps)."""
    out = {}
    convert._flatten(tree, prefix, out)
    return {k: np.array(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_stage1(ranks):
    """The JAX step on a ("data",) mesh of two devices, fsdp off and on:
    bits/dim of steps 1-3, parameters after steps 1 and 3."""
    jcfg = jglow.GlowConfig(use_pallas=True, **GLOW)
    jtcfg = jnft.NFTrainConfig(lr=1e-3)
    tx = joptim.make_optimizer("adam", 1e-3, fixed_prior=True)
    step = jnft.make_train_step(jcfg, jtcfg, tx, inject_noise=True)
    mesh = jmesh.make_mesh(n_data=2)
    out = {}
    for fsdp in (False, True):
        params = jax.tree.map(jnp.asarray, ranks["tree"])
        state = {"params": params, "opt_state": tx.init(params), "step": jnp.zeros((), jnp.int32)}
        bpds = []
        with mesh:
            state = jnft.shard_nf_state(mesh, tx, state, fsdp=fsdp)
            for i in range(3):
                state, m = step(state, jmesh.shard_batch(mesh, jnp.asarray(ranks["imgs"][i])),
                                jnp.asarray(ranks["noise"][i]))
                bpds.append(float(m["bpd"]))
                if i == 0:  # copied: the step donates its state's buffers
                    out[f"fsdp{int(fsdp)}/step1"] = _flat(jax.tree.map(np.array, state["params"]))
        out[f"fsdp{int(fsdp)}/bpd"] = np.asarray(bpds)
        out[f"fsdp{int(fsdp)}/step3"] = _flat(to_numpy_tree(state["params"]))
    return out


def _port_world1_stage1(ranks, mode):
    cfg = tglow.GlowConfig(**GLOW)
    tcfg = tnft.NFTrainConfig(lr=1e-3)
    tx = tnft.optimizer_of(tcfg)
    params = convert.trainable(convert.from_jax_params(ranks["tree"], "cpu"))
    state = {"params": params, "opt_state": tx.init(params), "step": 0}
    step = tnft.make_train_step(cfg, tcfg, tx, inject_noise=mode == "noise", device="cpu")
    bpds, after = [], {}
    for i in range(3):
        state, m = step(state, ranks["imgs"][i], ranks["noise"][i] if mode == "noise" else 5)
        bpds.append(float(m["bpd"]))
        if i == 0:
            after["step1"] = _flat(convert.to_jax_params(state["params"]))
    after["step3"] = _flat(convert.to_jax_params(state["params"]))
    return np.asarray(bpds), after


@pytest.mark.parametrize("fsdp", [0, 1])
def test_stage1_world2_matches_jax_mesh_and_world1(ranks, jax_stage1, fsdp):
    r0, r1 = (o["stage1"] for o in ranks["out"])
    tag = f"noise_fsdp{fsdp}"
    for k in r0:  # the ranks hold the same parameters, bit for bit
        if k.startswith(tag + "/step"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    bpd1, world1 = _port_world1_stage1(ranks, "noise")
    for want_bpd, want in ((jax_stage1[f"fsdp{fsdp}/bpd"], jax_stage1),
                           (bpd1, {f"fsdp{fsdp}/{s}": v for s, v in world1.items()})):
        np.testing.assert_allclose(r0[f"{tag}/bpd"], want_bpd, rtol=0, atol=BPD_TOL)
        for s in ("step1", "step3"):
            _params_close(_sub(r0, f"{tag}/{s}"), want[f"fsdp{fsdp}/{s}"])


@pytest.mark.parametrize("fsdp", [0, 1])
def test_stage1_world2_draws_the_world1_noise(ranks, fsdp):
    """The step's own generator: the global batch's draw cut to the rank's
    rows, so two ranks train as one does."""
    r0, r1 = (o["stage1"] for o in ranks["out"])
    bpd1, world1 = _port_world1_stage1(ranks, "seed")
    tag = f"seed_fsdp{fsdp}"
    np.testing.assert_allclose(r0[f"{tag}/bpd"], bpd1, rtol=0, atol=BPD_TOL)
    np.testing.assert_array_equal(r0[f"{tag}/bpd"], r1[f"{tag}/bpd"])
    for s in ("step1", "step3"):
        _params_close(_sub(r0, f"{tag}/{s}"), world1[s])


def test_stage1_zero_moments_are_the_ranks_slabs(ranks):
    for rank, out in enumerate(ranks["out"]):
        o = out["stage1"]
        shapes = _sub(o, "noise_fsdp1/moment_shape")
        assert len(shapes) >= 10  # conv kernels and PLU factors of both levels
        assert any("conv2/w" in k for k in shapes) and any("invconv" in k for k in shapes)
        for k, (got, want) in shapes.items():
            assert list(got) == list(want), (rank, k)
        assert not _sub(o, "noise_fsdp0/moment_shape")
        held, predicted = o["noise_fsdp1/moment_bytes"]
        assert held == predicted
        assert held < o["noise_fsdp0/moment_bytes"][0]


@pytest.fixture(scope="module")
def jax_stage2(ranks):
    out = {}
    mesh = jmesh.make_mesh(n_data=2)
    for conf in STAGE2:
        tree, imgs, key, _, jdp, glow2 = ranks["stage2"][conf["name"]]
        frozen = conf["frozen"]
        jtcfg = jdt.DiffusionTrainConfig(**conf["tcfg"])
        jtx = jdt.make_two_group_optimizer(jtcfg, frozen)
        step = jdt.make_train_step(JBackbone(glow2, IMG2, frozen=frozen), jdp, jtcfg, jtx)
        params = jax.tree.map(jnp.asarray, tree)
        state = {"params": params, "opt_state": jtx.init(params), "step": jnp.zeros((), jnp.int32)}
        losses = []
        with mesh:
            state = jmesh.replicate(mesh, state)
            for i in range(len(imgs)):
                state, m = step(state, jmesh.shard_batch(mesh, jnp.asarray(imgs[i])), key)
                losses.append(float(m["loss"]))
        params = to_numpy_tree(state["params"])
        params.pop("prior", None)
        out[conf["name"]] = (np.asarray(losses), _flat(params))
    return out


@pytest.mark.parametrize("fsdp", [0, 1])
@pytest.mark.parametrize("name", ["frozen", "cotrained"])
def test_stage2_world2_matches_jax_mesh_and_world1(ranks, jax_stage2, name, fsdp):
    from nfdpm_tpu_torch.models.nf_backbone import NFBackbone
    from nfdpm_tpu_torch.training import diffusion_trainer as tdt

    conf = next(c for c in STAGE2 if c["name"] == name)
    r0, r1 = (o["stage2"] for o in ranks["out"])
    tag = f"{name}_fsdp{fsdp}"
    params0 = _sub(r0, f"{tag}/params")
    for k, v in params0.items():
        np.testing.assert_array_equal(v, r1[f"{tag}/params/{k}"], err_msg=k)
    # the port at one rank, in this process, on the same draws
    tree, imgs, _, draws, _, glow2 = ranks["stage2"][name]
    tdp = TDiffusionPrior(tfmt.get_formater(conf["formater"])(L=2, in_channels=3, size=IMG2),
                          dict(UNET), dict(DIFF))
    tcfg = tdt.DiffusionTrainConfig(**conf["tcfg"])
    tx = tdt.make_two_group_optimizer(tcfg, conf["frozen"])
    bb = NFBackbone(tglow.GlowConfig(**dict(GLOW, **GLOW2)), IMG2, frozen=conf["frozen"])
    params = convert.diffusion_from_jax_params(tree, tdp, "cpu", requires_grad=True)
    params.pop("prior")
    state = {"params": params, "opt_state": tx.init(params), "step": 0}
    step = tdt.make_train_step(bb, tdp, tcfg, tx, inject_noise=True, device="cpu")
    losses1 = []
    for i in range(len(imgs)):
        state, m = step(state, imgs[i], draws[i])
        losses1.append(float(m["loss"]))
    world1 = _flat(convert.diffusion_to_jax_params(state["params"]))
    world1.pop("prior", None)
    jlosses, jparams = jax_stage2[name]
    for want_losses, want in ((jlosses, jparams), (np.asarray(losses1), world1)):
        np.testing.assert_allclose(r0[f"{tag}/loss"], want_losses, rtol=1e-5, atol=0)
        got = {k: v for k, v in params0.items() if not k.startswith("prior")}
        _params_close(got, want)


@pytest.mark.parametrize("direction", ["world2_to_world1", "world1_to_world2"])
def test_cross_topology_resume(ranks, direction, tmp_path):
    """A checkpoint written at two ranks with fsdp (whole moments, rank 0)
    resumes at one rank, and one written at one rank resumes at two with
    fsdp: both end where the uninterrupted one-rank run ends."""
    want = _flat(convert.to_jax_params(ranks["runs"]["uninterrupted"]["state"]["params"]))
    want_bpd = ranks["runs"]["uninterrupted"]["results"]
    if direction == "world1_to_world2":
        r0, r1 = (o["resume"] for o in ranks["out"])
        got = {k: v for k, v in _sub(r0, "from_world1").items() if k != "bpd"}
        np.testing.assert_array_equal(r0["from_world1/bpd"], r1["from_world1/bpd"])
        bpd = r0["from_world1/bpd"]
    else:
        tcfg = tnft.NFTrainConfig(epochs=1, lr=1e-3, print_freq=100, save_checkpoint_freq=100)
        res = tnft.train(cfg=ranks["cfg"], tcfg=tcfg, loaders=_loaders(),
                         run_dir=str(tmp_path / "resumed"), logger=logging.getLogger("resume"),
                         seed=0, img_size=IMG, resume_dir=str(ranks["d"] / "first_epoch"),
                         resume_epoch=1, device="cpu")
        got = _flat(convert.to_jax_params(res["state"]["params"]))
        bpd = [res["results"]["bpd_test"], res["results"]["bpd_train"]]
        saved = torch.load(ranks["d"] / "first_epoch" / "checkpoints" / "model_gaussian_001.pt",
                           weights_only=True)
        mu = dict(convert.named_leaves(saved["opt_state"]["mu"]))
        params = dict(convert.named_leaves(saved["params"]))
        assert all(mu[k].shape == params[k].shape for k in params)  # whole moments
    _params_close(got, want)
    np.testing.assert_allclose(bpd, [want_bpd["bpd_test"], want_bpd["bpd_train"]],
                               rtol=0, atol=BPD_TOL)


def test_samplers_over_the_ranks_give_one_devices_bytes(ranks):
    """A Glow chunk and a stage-2 DDIM chunk of 5 images (blocks of 3 and 2):
    every rank's gathered samples are the bytes one process draws."""
    from nfdpm_tpu_torch.models.nf_backbone import NFBackbone
    from nfdpm_tpu_torch.training import diffusion_trainer as tdt

    glow = tnft.make_sample_fn(tglow.GlowConfig(**GLOW), tnft.NFTrainConfig(), IMG, 3, "cpu")
    want = {"glow": glow(convert.from_jax_params(ranks["tree"], "cpu"), 5, 0.8, 2).numpy()}
    tdp = TDiffusionPrior(tfmt.IdentityFormater(L=2, in_channels=3, size=IMG2), dict(UNET),
                          dict(DIFF))
    bb = NFBackbone(tglow.GlowConfig(**dict(GLOW, **GLOW2)), IMG2, frozen=True)
    sample = tdt.make_sample_fn(bb, tdp, tdt.DiffusionTrainConfig(), 3, "cpu")
    tree2 = ranks["stage2"]["frozen"][0]
    want["diffusion"] = sample(convert.diffusion_from_jax_params(tree2, tdp, "cpu"), 5, 1.0,
                               2).numpy()
    for out in ranks["out"]:
        for kind in ("glow", "diffusion"):
            assert out["sampling"][kind].dtype == np.uint8
            np.testing.assert_array_equal(out["sampling"][kind], want[kind], err_msg=kind)


def test_features_of_the_ranks_rows_are_one_devices(ranks):
    """13 images in batches of 5 over two ranks (blocks of 3 and 2, and 2
    and 1): the gathered features, in order, are one process's."""
    from nfdpm_tpu_torch.metrics import fid

    data = np.load(ranks["d"] / "features.npz")
    w = torch.from_numpy(data["w"])
    want = fid.extract_features(data["images"], lambda x: x.mean(dim=(1, 2)) @ w, 12,
                                "legacy_tensorflow", batch_size=5, device="cpu")
    for out in ranks["out"]:
        np.testing.assert_allclose(out["features"]["feats"], want, rtol=1e-6, atol=1e-6)


def test_emergency_save_names_the_rank_when_a_rank_is_gone(ranks):
    """Rank 1 stopped answering: rank 0's gather of the moments and its
    barrier after a checkpoint raise at their 3-s limit, naming rank 0,
    instead of hanging."""
    gone = ranks["out"][0]["gone"]
    assert "gone" not in ranks["out"][1]
    for name in ("gather", "barrier"):
        message = str(gone[f"{name}/error"])
        assert message.startswith("rank 0 of 2: ") and "within 3 s" in message, message
        assert 3.0 <= float(gone[f"{name}/seconds"]) < 5.0


# ---------------------------------------------------------------------------
# The kernels' build lock
# ---------------------------------------------------------------------------

def test_build_lock_runs_one_compile(tmp_path):
    """Two processes that find the library missing call build() together:
    under the lock one runs (a stand-in for) nvcc, the other waits, finds it
    current and loads the same file."""
    # a real shared library for the stand-in to "build": this process's libm
    with open("/proc/self/maps") as f:
        libm = next(line.split()[-1] for line in f if "/libm" in line and ".so" in line)
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text("\n".join([
        "#!" + sys.executable,
        "import shutil, sys, time",
        "with open(%r, 'a') as f:" % str(tmp_path / "compiles"),
        "    f.write('1')",
        "time.sleep(1.0)",
        "shutil.copyfile(%r, sys.argv[sys.argv.index('-o') + 1])" % libm, ""]))
    nvcc.chmod(0o755)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = "\n".join([
        "import ctypes, os, sys",
        "from pathlib import Path",
        "sys.path.insert(0, %r)" % repo,
        "from nfdpm_tpu_torch.ops.kernels import _build",
        "_build.BUILD_DIR = Path(%r)" % str(tmp_path / "build"),
        "_build.build(['flow_kernels'])",
        "lib = _build.library_path('flow_kernels')",
        "ctypes.CDLL(str(lib))",
        "print(os.stat(lib).st_ino)", ""])
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}")
    procs = [subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for _ in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=60)
        finally:
            if p.poll() is None:
                p.kill()
        assert p.returncode == 0, err
        outs.append(out.split()[-1])
    assert (tmp_path / "compiles").read_text().count("1") == 1
    assert outs[0] == outs[1]
    assert not list((tmp_path / "build").glob("*.tmp"))
