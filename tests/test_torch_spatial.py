"""Spatial partitioning (`parallel.spatial`: image rows of the flow over the
model axis, explicit halo exchange; nfdpm_tpu_torch/parallel/spatial.py)
on gloo ranks on the CPU, against nfdpm_tpu: the counterparts of the JAX
package's tests/test_parallel.py spatial tests.

Two launches (tests/_torch_spatial_scenarios.py; the worker's `entry`):
  * two ranks at (data 1, model 2): the row convolution at 2 rows and 1 row
    a shard; stage 1 (tests/test_parallel.py's CFG: L2/K2/w32, 16x16x3,
    batch 16, the injected noise), step 1's bits/dim against the JAX
    package's single-device step (rtol 1e-5) and its gradients against
    jax.grad of the JAX loss (rtol 1e-4 / atol 1e-6, the port's gradient
    bound), four Adam steps against the port at one rank (bits/dim within
    1e-3, parameters within 2e-3: the data-parallel gates); grad_accum=2,
    remat and bf16 each against their one-rank step; stage 2 (the JAX
    spatial diffusion test's L2/K1/w32, 16x16, UNet dim 8, mults (1, 2),
    groups 2, T 4), frozen and co-trained: the loss (rtol 1e-5) and
    gradients against the JAX package's, two steps against one rank; the
    bytes autograd saves at L2/K2/w64, 32x32, batch 8 (spatial under 0.8x
    the data-only step's, the JAX test's bound); a spatial run's checkpoint
    scored and resumed at one rank; both entry points with
    parallel.n_model=2 parallel.spatial=true against one process.
  * four ranks at (2, 2): the row convolution over a model axis of 4 (2
    rows and 1 row a shard); stage 1's step 1 and trajectory as above;
    fsdp with spatial against one rank.
And in this process: the guard against the JAX package's on a grid of
(img_size, L, n_model) with real JAX meshes.
"""

import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port import jax_diffusion_draws, one_torch_thread, randomize, run_ranks, to_numpy_tree
from nfdpm_tpu.models import formaters as jfmt
from nfdpm_tpu.models import glow as jglow
from nfdpm_tpu.models import prior as jprior
from nfdpm_tpu.models.diffusion_prior import DiffusionPrior as JDiffusionPrior
from nfdpm_tpu.models.nf_backbone import NFBackbone as JBackbone
from nfdpm_tpu.ops import quantize as jq
from nfdpm_tpu.parallel import mesh as jmesh
from nfdpm_tpu_torch import convert, run_baseline, run_diffusion_prior
from nfdpm_tpu_torch.data import pipeline as tpipe
from nfdpm_tpu_torch.models import formaters as tfmt
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.models.diffusion_prior import DiffusionPrior as TDiffusionPrior
from nfdpm_tpu_torch.models.nf_backbone import NFBackbone
from nfdpm_tpu_torch.parallel import mesh as tmesh
from nfdpm_tpu_torch.training import diffusion_trainer as tdt
from nfdpm_tpu_torch.training import nf_trainer as tnft

IMG, BATCH, N_BITS = 16, 16, 5
CFG = dict(in_channels=3, levels=2, steps=2, coupling_width=32, learn_prior=True)
GLOW2 = dict(steps=1)
UNET = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=2)
DIFF = dict(timesteps=4, beta_schedule="cosine", loss_type="l2")
BATCH2, STEPS2 = 8, 2
STAGE2 = [dict(name="frozen", formater="IdentityFormater", frozen=True,
               tcfg=dict(lr_diffusion=1e-3)),
          dict(name="cotrained", formater="IdentityFormater", frozen=False,
               tcfg=dict(lr_diffusion=1e-3, lr_nf=3e-4))]
VARIANTS_12 = [dict(name="adam", steps=4, grads=True),
               dict(name="grad_accum", steps=2, tcfg=dict(grad_accum=2), seed=5),
               dict(name="remat", steps=2, glow=dict(remat=True)),
               dict(name="bf16", steps=2, glow=dict(coupling_dtype="bfloat16"))]
VARIANTS_22 = [dict(name="adam", steps=4, grads=True),
               dict(name="fsdp", steps=2, fsdp=True)]
MEMORY_GLOW = dict(in_channels=3, levels=2, steps=2, coupling_width=64)
CHECKPOINT = dict(img=16, batch=8, n=16, glow=dict(steps=1, coupling_width=16))
BPD_TOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6
TRAJ_TOL, PARAM_ATOL = 1e-3, 2e-3  # chip_smoke.py TRAIN_TRAJ_TOL, MG_FINAL_ATOL
CONV_TOL = 1e-6  # in float64: a misplaced halo row would move values by O(1)
SMALL = ["device=cpu", "data.name=synthetic", "data.synthetic_fallback=true",
         "data.batch_size=8", "data.img_size=16", "data.synthetic_n=16",
         "model.architecture.L=2", "model.architecture.K=1",
         "model.architecture.coupling_width=16", "model.training.epochs=1",
         "model.training.save_checkpoint_freq=1", "model.training.print_freq=1",
         "experiment_name=s1_sp"]
S2 = ["device=cpu", "data.name=synthetic", "data.synthetic_fallback=true",
      "data.batch_size=8", "data.img_size=16", "data.synthetic_n=16",
      "model.normalizing_flow.init_nf.pretrain.dir={stage1}",
      "model.normalizing_flow.init_nf.pretrain.epoch=1", "model.unet.dim=8",
      "model.unet.dim_mults=[1,2]", "model.unet.resnet_block_groups=2",
      "model.diffusion.timesteps=8", "model.diffusion.sampling_timesteps=4",
      "model.training.epochs=1", "model.training.print_freq=1",
      "model.training.save_checkpoint_freq=1", "model.evaluation.vlb_batches=1"]
SPATIAL = ["parallel.n_model=2", "parallel.spatial=true"]
ENTRY2 = {"s2": S2 + ["experiment_name=s2_sp"],
          "s2_cotrained": S2 + ["experiment_name=s2_sp_cot", "model.normalizing_flow.freeze=false",
                                "model.normalizing_flow.lr=1e-4"]}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _flat(tree, prefix=""):
    out = {}
    convert._flatten(tree, prefix, out)
    return {k: np.array(v) for k, v in out.items()}


def _sub(out, prefix):
    return {k[len(prefix) + 1:]: v for k, v in out.items() if k.startswith(prefix + "/")}


def _close_trees(got, want, rtol=0.0, atol=PARAM_ATOL):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def _conv_inputs(d, n_model, rng):
    """float64, so that the sums' blocking (which differs with the rows a
    convolution sees) stays far below the tolerance."""
    arrays = {"w": rng.standard_normal((4, 3, 3, 3))}
    for rows in (2, 1):
        shape = (2, rows * n_model, 5, 3)
        arrays[f"x{rows}"] = rng.standard_normal(shape)
        arrays[f"g{rows}"] = rng.standard_normal(shape[:3] + (4,))
    np.savez(d / "conv.npz", **arrays)
    return arrays


def _stage2_inputs(d, conf):
    jformater = jfmt.get_formater(conf["formater"])(L=2, in_channels=3, size=IMG)
    tdp = TDiffusionPrior(tfmt.get_formater(conf["formater"])(L=2, in_channels=3, size=IMG),
                          dict(UNET), dict(DIFF))
    jdp = JDiffusionPrior(jformater, dict(UNET), dict(DIFF))
    unets = {"parts": tuple(convert.unet_to_flax(u) for u in tdp.init_params(2, "cpu")["parts"])}
    glow2 = jglow.GlowConfig(**dict(CFG, **GLOW2))
    tree = randomize(to_numpy_tree({"flow": jglow.init_glow(0, glow2), "diffusion": unets}),
                     seed=3, scale=0.02)
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (STEPS2, BATCH2, IMG, IMG, 3)).astype(np.float32) / 255.0
    key = jax.random.PRNGKey(11)
    shapes = [(BATCH2, *s) for s in jformater.input_shapes]
    draws = [jax_diffusion_draws(key, i, jdp, shapes, (BATCH2, IMG, IMG, 3))
             for i in range(STEPS2)]
    convert.save_npz(d / f"stage2_{conf['name']}_tree.npz", tree)
    flat = {"imgs": imgs}
    for i, dr in enumerate(draws):
        flat[f"dequant_{i}"] = dr["dequant"]
        for j, part in enumerate(dr["parts"]):
            flat.update({f"t_{i}_{j}": part["t"], f"noise_{i}_{j}": part["noise"],
                         f"coin_{i}_{j}": np.asarray(part["self_cond"])})
    np.savez(d / f"stage2_{conf['name']}.npz", **flat)
    return dict(tree=tree, imgs=imgs, key=key, draws=draws, jdp=jdp, glow2=glow2, tdp=tdp)


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Both launches' outputs, with the inputs they were given."""
    rng = np.random.default_rng(11)
    tree = randomize(to_numpy_tree({"flow": jglow.init_glow(0, jglow.GlowConfig(**CFG)),
                                    "prior": jprior.init_gaussian_prior(24, True)}), seed=1)
    imgs = rng.integers(0, 256, (4, BATCH, IMG, IMG, 3)).astype(np.float32) / 255.0
    noise = rng.random(imgs.shape).astype(np.float32)
    memory = {"imgs": rng.integers(0, 256, (8, 32, 32, 3)).astype(np.float32) / 255.0,
              "noise": rng.random((8, 32, 32, 3)).astype(np.float32)}
    base = {"glow": CFG, "glow2": GLOW2, "img2": IMG, "unet": UNET, "diff": DIFF,
            "stage2": STAGE2, "memory_glow": MEMORY_GLOW, "checkpoint": CHECKPOINT}
    out, conv, stage2 = {}, {}, {}
    for name, world, extra in (
            ("model2", 2, {"scenarios": ["row_conv", "sp_stage1", "sp_stage2", "sp_memory",
                                         "sp_checkpoint", "entry"],
                           "stage1_variants": VARIANTS_12,
                           "entry": {"stage1": SMALL + SPATIAL,
                                     "stage2": {k: v + SPATIAL for k, v in ENTRY2.items()}}}),
            ("mesh4", 4, {"scenarios": ["row_conv", "sp_stage1"], "conv_n_model": 4,
                          "stage1_variants": VARIANTS_22, "fsdp_min_size": 256})):
        d = tmp_path_factory.mktemp(f"spatial_{name}")
        convert.save_npz(d / "stage1_tree.npz", tree)
        np.savez(d / "stage1.npz", imgs=imgs, noise=noise)
        np.savez(d / "memory.npz", **memory)
        conv[name] = _conv_inputs(d, 2 if world == 2 else 4, rng)
        if "sp_stage2" in extra["scenarios"]:
            for conf in STAGE2:
                stage2[conf["name"]] = _stage2_inputs(d, conf)
        out[name] = run_ranks({**base, "n_model": 2, **extra}, world, d, timeout_s=300.0)
        out[f"{name}_dir"] = d
    return dict(out=out, tree=tree, imgs=imgs, noise=noise, conv=conv, stage2=stage2)


# ---------------------------------------------------------------------------
# The guard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_model", [1, 2, 4, 8])
def test_guard_accepts_and_refuses_what_the_jax_package_does(n_model):
    """checked_spatial against nfdpm_tpu.parallel.mesh.checked_spatial_sharding
    on a real JAX mesh of 8 CPU devices: the same sizes pass, the same raise
    with the same message."""
    jm = jmesh.make_mesh(n_data=8 // n_model, n_model=n_model)
    tm = tmesh.Mesh(world=n_model, rank=0, group=None, devices=(torch.device("cpu"),),
                    n_model=n_model)
    for img in (4, 8, 16, 32, 64, 128):
        for levels in (1, 2, 3, 4):
            try:
                jmesh.checked_spatial_sharding(jm, img, levels)
                want = None
            except ValueError as e:
                want = str(e)
            try:
                got = tmesh.checked_spatial(tm, img, levels)
                assert want is None, (img, levels, want)
                assert got.spatial and got.n_model == n_model
            except ValueError as e:
                assert str(e) == want, (img, levels)


# ---------------------------------------------------------------------------
# The row convolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("launch,rows", [("model2", 2), ("model2", 1), ("mesh4", 2),
                                         ("mesh4", 1)])
def test_row_conv_equals_the_whole_conv(launches, launch, rows):
    """conv2d_nhwc_rows over model 2 and 4, at 2 rows and at 1 row a shard,
    equals F.conv2d of the whole image (SAME) forward, in the input's
    gradient and in the weight's summed over the model group (float64)."""
    a = launches["conv"][launch]
    x = torch.from_numpy(a[f"x{rows}"]).requires_grad_(True)
    w = torch.from_numpy(a["w"]).requires_grad_(True)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    (y * torch.from_numpy(a[f"g{rows}"])).sum().backward()
    for out in launches["out"][launch]:
        got = out["row_conv"]
        for what, want in (("y", y.detach()), ("dx", x.grad), ("dw", w.grad)):
            np.testing.assert_allclose(got[f"{rows}/{what}"], want.numpy(), rtol=0,
                                       atol=CONV_TOL, err_msg=what)


# ---------------------------------------------------------------------------
# Stage 1
# ---------------------------------------------------------------------------

def _jax_loss(jcfg, params, batch, noise):
    """nfdpm_tpu.training.nf_trainer.make_train_step's loss with
    inject_noise=True (a closure there)."""
    n_bins = jq.n_bins_of(N_BITS)
    x = jq.preprocess(batch, N_BITS) + noise / n_bins
    latents, ldj, logp = jglow.forward(params["flow"], jcfg, x)
    ll = ldj + logp + jprior.gaussian_prior_logp(params["prior"], latents[-1])
    return jprior.bits_per_dim(ll, n_bins, jprior.n_pixels(IMG, 3, True))


@pytest.fixture(scope="module")
def jax_stage1(launches):
    """The JAX package's single-device bits/dim and gradient of step 1."""
    bpd, grads = jax.jit(jax.value_and_grad(lambda p: _jax_loss(
        jglow.GlowConfig(**CFG), p, jnp.asarray(launches["imgs"][0]),
        jnp.asarray(launches["noise"][0]))))(jax.tree.map(jnp.asarray, launches["tree"]))
    want = dict(convert.named_leaves(convert.from_jax_params(to_numpy_tree(grads), "cpu")))
    # the leaves the optimizer updates: the flow's but p_mat and sign (the
    # Gaussian prior is fixed, and its gradient is no data ranks' mean)
    tx = tnft.optimizer_of(tnft.NFTrainConfig())
    return float(bpd), {k: v.numpy() for k, v in want.items() if tx.updates(k)}


def _world1_stage1(launches, variant):
    """The port at one rank: the variant's steps from the same tree."""
    cfg = tglow.GlowConfig(**dict(CFG, **variant.get("glow", {})))
    tcfg = tnft.NFTrainConfig(lr=1e-3, **variant.get("tcfg", {}))
    tx = tnft.optimizer_of(tcfg)
    params = convert.trainable(convert.from_jax_params(launches["tree"], "cpu"))
    state = {"params": params, "opt_state": tx.init(params), "step": 0}
    seeded = variant.get("seed") is not None
    step = tnft.make_train_step(cfg, tcfg, tx, inject_noise=not seeded, device="cpu")
    bpds = []
    for i in range(variant["steps"]):
        state, m = step(state, launches["imgs"][i],
                        variant["seed"] if seeded else launches["noise"][i])
        bpds.append(float(m["bpd"]))
    return np.asarray(bpds), _flat(convert.to_jax_params(state["params"]))


@pytest.mark.parametrize("launch", ["model2", "mesh4"])
def test_stage1_step_matches_jax_and_world1(launches, jax_stage1, launch):
    """Step 1's bits/dim within rtol 1e-5 of the JAX package's single-device
    step and its gradients within the port's gradient bound of jax.grad; four
    Adam steps within the data-parallel gates of the port at one rank; every
    rank holds the whole flow and the same values."""
    outs = [o["sp_stage1"] for o in launches["out"][launch]]
    bpd_j, grads_j = jax_stage1
    bpd1, params1 = _world1_stage1(launches, VARIANTS_12[0])
    whole = sum(v.nbytes for k, v in params1.items() if k.startswith("flow/"))
    for out in outs:
        np.testing.assert_allclose(out["adam/bpd"][0], bpd_j, rtol=BPD_TOL)
        grads = _sub(out, "adam/grad")
        assert grads_j.keys() <= grads.keys()
        for k in grads_j:
            g = grads[k]
            np.testing.assert_allclose(g, grads_j[k], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)
        np.testing.assert_allclose(out["adam/bpd"], bpd1, rtol=0, atol=TRAJ_TOL)
        _close_trees(_sub(out, "adam/params"), params1)
        assert int(out["adam/flow_bytes"]) == whole  # no slabs of the flow
        for k in out:  # a leaf that is not updated keeps its data rank's gradient
            if not k.startswith("adam/grad/") or k[len("adam/grad/"):] in grads_j:
                np.testing.assert_array_equal(out[k], outs[0][k], err_msg=k)


@pytest.mark.parametrize("launch,name", [("mesh4", "fsdp"), ("model2", "grad_accum"),
                                         ("model2", "remat"), ("model2", "bf16")])
def test_spatial_composes_with_the_other_options(launches, launch, name):
    """fsdp at (2, 2), grad_accum=2, remat and bf16 at (1, 2), each against
    its step at one rank: bits/dim within rtol 1e-5 at step 1 and within
    1e-3 at each step, parameters within 2e-3 after two steps."""
    variants = VARIANTS_22 if launch == "mesh4" else VARIANTS_12
    variant = next(v for v in variants if v["name"] == name)
    bpd1, params1 = _world1_stage1(launches, variant)
    for o in launches["out"][launch]:
        out = o["sp_stage1"]
        np.testing.assert_allclose(out[f"{name}/bpd"][0], bpd1[0], rtol=BPD_TOL)
        np.testing.assert_allclose(out[f"{name}/bpd"], bpd1, rtol=0, atol=TRAJ_TOL)
        _close_trees(_sub(out, f"{name}/params"), params1)
    if name == "fsdp":  # the data axis partitions: less than the whole flow a rank
        flow = sum(v.nbytes for k, v in params1.items() if k.startswith("flow/"))
        assert int(launches["out"][launch][0]["sp_stage1"]["fsdp/flow_bytes"]) < flow


def test_spatial_step_saves_under_0p8_of_the_data_only_step(launches):
    """The counterpart of test_spatial_partitions_activation_memory: the
    bytes autograd saves in a step a rank, the rank's 8 images at half
    height against whole."""
    for o in launches["out"]["model2"]:
        out = o["sp_memory"]
        assert out["spatial/bytes"] < 0.8 * out["data_only/bytes"], (
            out["spatial/bytes"], out["data_only/bytes"])


# ---------------------------------------------------------------------------
# Stage 2
# ---------------------------------------------------------------------------

def _jax_stage2_loss(s, frozen, params, batch, key):
    """nfdpm_tpu.training.diffusion_trainer.make_train_step's loss (a
    closure there) at the step key."""
    import math

    k_dq, k_diff = jax.random.split(key)
    x = jq.dequantize(k_dq, jq.preprocess(batch, N_BITS), N_BITS)
    bb = JBackbone(cfg=s["glow2"], img_size=IMG, frozen=frozen)
    latents, ldj = bb.transform(params["flow"], x)
    loss = sum(s["jdp"].losses(params["diffusion"], k_diff, latents))
    if not frozen:
        n_pixel = jprior.n_pixels(IMG, 3, True)
        weight = tdt.DiffusionTrainConfig().nf_bpd_weight
        loss = loss + weight * jnp.mean(-ldj / (math.log(2.0) * n_pixel))
    return loss


def _world1_stage2(s, conf):
    tcfg = tdt.DiffusionTrainConfig(**conf["tcfg"])
    tx = tdt.make_two_group_optimizer(tcfg, conf["frozen"])
    bb = NFBackbone(tglow.GlowConfig(**dict(CFG, **GLOW2)), IMG, frozen=conf["frozen"])
    params = convert.diffusion_from_jax_params(s["tree"], s["tdp"], "cpu", requires_grad=True)
    params.pop("prior")
    state = {"params": params, "opt_state": tx.init(params), "step": 0}
    step = tdt.make_train_step(bb, s["tdp"], tcfg, tx, inject_noise=True, device="cpu")
    losses = []
    for i in range(STEPS2):
        state, m = step(state, s["imgs"][i], s["draws"][i])
        losses.append(float(m["loss"]))
    tree = convert.diffusion_to_jax_params(state["params"])
    tree.pop("prior", None)
    return np.asarray(losses), _flat(tree)


@pytest.mark.parametrize("name", ["frozen", "cotrained"])
def test_stage2_step_matches_jax_and_world1(launches, name):
    """The loss of step 1 within rtol 1e-5 of the JAX package's and every
    gradient (the UNets', the co-trained flow's) within the port's gradient
    bound of jax.grad of its loss; two steps against one rank (the loss
    within rtol 1e-5, parameters within 2e-3)."""
    conf = next(c for c in STAGE2 if c["name"] == name)
    s = launches["stage2"][name]
    key = jax.random.fold_in(s["key"], 0)
    loss_j, grads_j = jax.value_and_grad(lambda p: _jax_stage2_loss(
        s, conf["frozen"], p, jnp.asarray(s["imgs"][0]), key))(
        jax.tree.map(jnp.asarray, s["tree"]))
    want = convert.diffusion_from_jax_params(to_numpy_tree(grads_j), s["tdp"], "cpu")
    want = {k: v.detach().numpy() for k, v in convert.named_leaves(
        {"flow": want["flow"], "diffusion": want["diffusion"]})}
    losses1, params1 = _world1_stage2(s, conf)
    for o in launches["out"]["model2"]:
        out = o["sp_stage2"]
        np.testing.assert_allclose(out[f"{name}/loss"][0], float(loss_j), rtol=BPD_TOL)
        grads = _sub(out, f"{name}/grad")
        # the co-trained flow's trained leaves but the split priors', which
        # the transform does not reach (jax.grad gives them zeros)
        expected = {k for k in want if k.startswith("diffusion/")
                    or (not conf["frozen"] and "/split/" not in k
                        and not k.endswith(("p_mat", "sign")))}
        assert grads.keys() == expected
        for k, g in grads.items():
            np.testing.assert_allclose(g, want[k], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)
        np.testing.assert_allclose(out[f"{name}/loss"], losses1, rtol=BPD_TOL)
        _close_trees(_sub(out, f"{name}/params"), params1)


# ---------------------------------------------------------------------------
# Checkpoints and the entry points
# ---------------------------------------------------------------------------

def _checkpoint_run(run_dir, epochs, **kw):
    c = CHECKPOINT
    tcfg = tnft.NFTrainConfig(epochs=epochs, lr=1e-3, print_freq=100, save_checkpoint_freq=100)
    loaders = tpipe.read_dataset("synthetic", "", batch_size=c["batch"], img_size=c["img"],
                                 seed=0, synthetic_fallback=True, synthetic_n=c["n"])
    return tnft.train(cfg=tglow.GlowConfig(**dict(CFG, **c["glow"])), tcfg=tcfg,
                      loaders=loaders, run_dir=str(run_dir), logger=logging.getLogger("sp"),
                      seed=0, img_size=c["img"], device="cpu", **kw)


def test_spatial_checkpoint_resumes_and_scores_at_one_rank(launches, tmp_path, monkeypatch):
    """The spatial run's checkpoint holds the one-device layout: at one rank
    it scores the run's final bits/dim, and resumed for an epoch it ends
    where the uninterrupted one-rank run of two epochs ends."""
    monkeypatch.setenv("NFDPM_NO_TENSORBOARD", "1")
    r0, r1 = (o["sp_checkpoint"] for o in launches["out"]["model2"])
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    run = launches["out"]["model2_dir"] / "spatial_run"
    first = _checkpoint_run(tmp_path / "world1", 1)
    np.testing.assert_allclose(r0["bpd"], [first["results"]["bpd_test"],
                                           first["results"]["bpd_train"]], rtol=0, atol=1e-4)
    resumed = _checkpoint_run(tmp_path / "resumed", 1, resume_dir=str(run), resume_epoch=1)
    whole = _checkpoint_run(tmp_path / "uninterrupted", 2)
    _close_trees(_flat(convert.to_jax_params(resumed["state"]["params"])),
                 _flat(convert.to_jax_params(whole["state"]["params"])))
    np.testing.assert_allclose([resumed["results"]["bpd_test"], resumed["results"]["bpd_train"]],
                               [whole["results"]["bpd_test"], whole["results"]["bpd_train"]],
                               rtol=0, atol=1e-4)


def test_entry_points_train_spatially_and_match_one_process(launches, monkeypatch, tmp_path):
    """run_baseline.main and run_diffusion_prior.main (frozen and co-trained)
    with parallel.n_model=2 parallel.spatial=true on two gloo ranks: the
    final bits/dim and VLBs of the same runs in one process, and the log's
    spatial line."""
    r0, r1 = (o["entry"] for o in launches["out"]["model2"])
    for key in r0:
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("NFDPM_NO_TENSORBOARD", "1")
    s1 = run_baseline.main(SMALL)
    np.testing.assert_allclose(r0["stage1/bpd"], [s1["results"]["bpd_test"],
                                                  s1["results"]["bpd_train"]], rtol=0, atol=1e-4)
    for name, argv in ENTRY2.items():
        s2 = run_diffusion_prior.main([a.replace("{stage1}", Path(s1["run_dir"]).name)
                                       for a in argv])
        np.testing.assert_allclose(r0[f"{name}/vlb"], s2["vlb_bpd"], rtol=1e-4)
    # rank 0's log of the process: stage 1's run, then both stage-2 runs
    log = next((launches["out"]["model2_dir"] / "outputs").glob("s1_sp_*/train.log"))
    assert log.read_text().count("Spatial partitioning: H over model=2") == 3
