"""The model axis's training, evaluation, checkpoints and entry points, at
(data 1, model 2) on two gloo ranks, against nfdpm_tpu on the CPU.

One launch (tests/_torch_tp_scenarios.py: tp_steps, evaluation,
checkpoints, tp_entry):
  * stage-1 steps with the injected global noise against the JAX step on
    make_mesh(n_data=1, n_model=2) and against the port at one rank; with
    the step's own generator against one rank. Each rank's parameters and
    moments are its slabs (shapes and bytes as the placements predict);
    the replicated leaves are bitwise equal on the two ranks.
  * stage-2 steps, frozen and co-trained (with an in-step EMA), with the
    JAX package's draws injected, against the JAX step on the (1, 2) mesh
    and the port at one rank.
  * bits/dim (one draw and IWAE), the Glow sampler, the VLB and a DDIM and
    a DDPM chunk against one rank.
  * a cross-topology resume: model 2 -> 1 and 1 -> 2.
  * both entry points with parallel.n_model=2: stage 1 and stage 2 each an
    epoch on tiny data against the same runs in one process, and
    phase=eval repeats the final numbers.
Bounds: tests/test_parallel.py's (bits/dim or loss rtol 1e-5, parameters
rtol 3e-4 / atol 1e-5 after a step), the data-parallel trajectory bound
over three steps (parameters rtol 1e-3 / atol 1e-5), the samplers'
latents 1e-4.
Glow L2/K2, width 16, 8x8x3, batch 8; UNets of dim 8 (2 groups) at 16x16,
batch 4.
"""

import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_diffusion_draws, one_torch_thread, randomize, run_ranks, to_numpy_tree
from nfdpm_tpu.models import formaters as jfmt
from nfdpm_tpu.models import glow as jglow
from nfdpm_tpu.models import prior as jprior
from nfdpm_tpu.models.diffusion_prior import DiffusionPrior as JDiffusionPrior
from nfdpm_tpu.models.nf_backbone import NFBackbone as JBackbone
from nfdpm_tpu.parallel import mesh as jmesh
from nfdpm_tpu.training import diffusion_trainer as jdt
from nfdpm_tpu.training import nf_trainer as jnft
from nfdpm_tpu.training import optim as joptim
from nfdpm_tpu_torch import convert, inference, run_baseline, run_diffusion_prior
from nfdpm_tpu_torch.data import pipeline as tpipe
from nfdpm_tpu_torch.models import formaters as tfmt
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.models.diffusion_prior import DiffusionPrior as TDiffusionPrior
from nfdpm_tpu_torch.models.nf_backbone import NFBackbone
from nfdpm_tpu_torch.parallel import sharding_rules as trules
from nfdpm_tpu_torch.training import diffusion_trainer as tdt
from nfdpm_tpu_torch.training import nf_trainer as tnft

IMG, BATCH, IMG2, BATCH2 = 8, 8, 16, 4
GLOW = dict(in_channels=3, levels=2, steps=2, coupling_width=16, learn_prior=True)
GLOW2 = dict(steps=1, learn_prior=True)
UNET = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=2)
DIFF = dict(timesteps=8, sampling_timesteps=4, loss_type="l1", beta_schedule="cosine")
STAGE2 = [dict(name="frozen", formater="IdentityFormater", frozen=True,
               tcfg=dict(lr_diffusion=1e-3)),
          dict(name="cotrained", formater="CatFormater", frozen=False,
               tcfg=dict(lr_diffusion=1e-3, lr_nf=3e-4, ema_decay=0.9, ema_update_every=1))]
RTOL, ATOL, BPD_TOL, TRAJ_RTOL = 3e-4, 1e-5, 1e-5, 1e-3
SMALL = ["data.name=synthetic", "data.synthetic_fallback=true", "data.batch_size=8",
         "data.img_size=8", "data.synthetic_n=32", "model.architecture.L=2",
         "model.architecture.K=1", "model.architecture.coupling_width=16",
         "model.training.epochs=1", "model.training.save_checkpoint_freq=1",
         "model.training.print_freq=2"]
S2 = ["device=cpu", "data.name=synthetic", "data.synthetic_fallback=true",
      "data.batch_size=8", "data.img_size=8", "data.synthetic_n=16",
      "model.normalizing_flow.init_nf.pretrain.dir={stage1}",
      "model.normalizing_flow.init_nf.pretrain.epoch=1", "model.unet.dim=8",
      "model.unet.dim_mults=[1,2]", "model.unet.resnet_block_groups=2",
      "model.diffusion.timesteps=8", "model.diffusion.sampling_timesteps=4",
      "model.training.epochs=1", "model.training.print_freq=2",
      "model.training.save_checkpoint_freq=1", "model.evaluation.vlb_batches=1",
      "experiment_name=s2_tp"]


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


def _params_close(got, want, rtol=RTOL, atol=ATOL):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def _loaders():
    return tpipe.read_dataset("synthetic", "", batch_size=BATCH, img_size=IMG, seed=0,
                              synthetic_fallback=True, synthetic_n=32)


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
    return dict(tree=tree, imgs=imgs, key=key, draws=draws, jdp=jdp, glow2=glow2, tdp=tdp)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_train")
    jcfg = jglow.GlowConfig(**GLOW)
    tree = randomize(to_numpy_tree({"flow": jglow.init_glow(0, jcfg),
                                    "prior": jprior.init_gaussian_prior(24, True)}), seed=1)
    rng = np.random.default_rng(11)
    imgs = rng.integers(0, 256, (3, BATCH, IMG, IMG, 3)).astype(np.float32) / 255.0
    noise = rng.random(imgs.shape).astype(np.float32)
    convert.save_npz(d / "stage1_tree.npz", tree)
    np.savez(d / "stage1.npz", imgs=imgs, noise=noise)
    stage2 = {}
    for conf in STAGE2:
        s = stage2[conf["name"]] = _stage2_inputs(conf)
        convert.save_npz(d / f"stage2_{conf['name']}_tree.npz", s["tree"])
        flat = {"imgs": s["imgs"]}
        for i, dr in enumerate(s["draws"]):
            flat[f"dequant_{i}"] = dr["dequant"]
            for j, part in enumerate(dr["parts"]):
                flat.update({f"t_{i}_{j}": part["t"], f"noise_{i}_{j}": part["noise"],
                             f"coin_{i}_{j}": np.asarray(part["self_cond"])})
        np.savez(d / f"stage2_{conf['name']}.npz", **flat)
    # one rank's first epoch (the checkpoint the ranks resume) and its
    # uninterrupted two-epoch run
    runs = {}
    for name, epochs in (("world1_run", 1), ("uninterrupted", 2)):
        tcfg = tnft.NFTrainConfig(epochs=epochs, lr=1e-3, print_freq=100,
                                  save_checkpoint_freq=100)
        runs[name] = tnft.train(cfg=tglow.GlowConfig(**GLOW), tcfg=tcfg, loaders=_loaders(),
                                run_dir=str(d / name), logger=logging.getLogger("tp"), seed=0,
                                img_size=IMG, device="cpu")
    job = {"scenarios": ["tp_steps", "evaluation", "checkpoints", "tp_entry"], "n_model": 2,
           "glow": GLOW, "glow2": GLOW2, "img2": IMG2, "unet": UNET, "diff": DIFF,
           "stage2": STAGE2, "stage1_modes": [[False, "noise"], [False, "seed"]],
           "entry": {"stage1": ["device=cpu", *SMALL, "experiment_name=s1_tp",
                                "parallel.n_model=2"],
                     "stage2": {"s2": S2 + ["parallel.n_model=2"]}}}
    out = run_ranks(job, 2, d, timeout_s=240.0)
    return dict(d=d, tree=tree, imgs=imgs, noise=noise, stage2=stage2, out=out, runs=runs)


# ---------------------------------------------------------------------------
# Stage 1
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_stage1(ranks):
    jcfg = jglow.GlowConfig(**GLOW)
    tx = joptim.make_optimizer("adam", 1e-3, fixed_prior=True)
    step = jnft.make_train_step(jcfg, jnft.NFTrainConfig(lr=1e-3), tx, inject_noise=True)
    mesh = jmesh.make_mesh(n_data=1, n_model=2)
    params = jax.tree.map(jnp.asarray, ranks["tree"])
    state = {"params": params, "opt_state": tx.init(params), "step": jnp.zeros((), jnp.int32)}
    out, bpds = {}, []
    with mesh:
        state = jnft.shard_nf_state(mesh, tx, state)
        for i in range(3):
            state, m = step(state, jmesh.shard_batch(mesh, jnp.asarray(ranks["imgs"][i])),
                            jnp.asarray(ranks["noise"][i]))
            bpds.append(float(m["bpd"]))
            if i == 0:
                out["step1"] = _flat(jax.tree.map(np.array, state["params"]))
    out["bpd"], out["step3"] = np.asarray(bpds), _flat(to_numpy_tree(state["params"]))
    return out


def _world1_stage1(ranks, mode):
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


@pytest.mark.parametrize("mode", ["noise", "seed"])
def test_stage1_model2_matches_jax_mesh_and_world1(ranks, jax_stage1, mode):
    r0, r1 = (o["tp_steps"] for o in ranks["out"])
    tag = f"{mode}_fsdp0"
    for k in r0:  # the gathered parameters and the metrics agree on both ranks
        if k.startswith((f"{tag}/step", f"{tag}/bpd")):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    bpd1, world1 = _world1_stage1(ranks, mode)
    wants = [(bpd1, world1)]
    if mode == "noise":
        wants.append((jax_stage1["bpd"], jax_stage1))
    for want_bpd, want in wants:
        np.testing.assert_allclose(r0[f"{tag}/bpd"][0], want_bpd[0], rtol=BPD_TOL)
        np.testing.assert_allclose(r0[f"{tag}/bpd"], want_bpd, rtol=TRAJ_RTOL)
        _params_close(_sub(r0, f"{tag}/step1"), want["step1"])
        _params_close(_sub(r0, f"{tag}/step3"), want["step3"], rtol=TRAJ_RTOL)


def test_stage1_ranks_hold_their_slabs(ranks):
    """Each rank's parameters and moments of a model-sharded leaf have its
    slab's shape, its bytes are the placements' prediction, and a leaf
    replicated over the model axis is bitwise equal on both ranks."""
    r0, r1 = (o["tp_steps"] for o in ranks["out"])
    whole = dict(convert.named_leaves(convert.from_jax_params(ranks["tree"], "cpu")))
    placements = trules.glow_model_placements(
        convert.from_jax_params(ranks["tree"], "cpu")["flow"], 2)
    assert len(placements) == 5 * 4
    for rank, out in enumerate((r0, r1)):
        held = _sub(out, "noise_fsdp0/held")
        assert held.keys() == whole.keys()
        for path, t in whole.items():
            want = placements[path].slab(t, rank).shape if path in placements else t.shape
            assert held[path].shape == tuple(want), path
            if path not in placements:
                np.testing.assert_array_equal(held[path], r1["noise_fsdp0/held/" + path],
                                              err_msg=path)
        for path, (got, want) in _sub(out, "noise_fsdp0/moment_shape").items():
            assert list(got) == list(want), path
        params, predicted, moments, predicted_moments = out["noise_fsdp0/bytes"]
        assert params == predicted and moments == predicted_moments
        assert params < 4 * sum(t.numel() for t in whole.values())


# ---------------------------------------------------------------------------
# Stage 2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_stage2(ranks):
    out = {}
    mesh = jmesh.make_mesh(n_data=1, n_model=2)
    for conf in STAGE2:
        s = ranks["stage2"][conf["name"]]
        frozen = conf["frozen"]
        jtcfg = jdt.DiffusionTrainConfig(**conf["tcfg"])
        jtx = jdt.make_two_group_optimizer(jtcfg, frozen)
        step = jdt.make_train_step(JBackbone(s["glow2"], IMG2, frozen=frozen), s["jdp"], jtcfg,
                                   jtx)
        params = jax.tree.map(jnp.asarray, s["tree"])
        state = {"params": params, "opt_state": jtx.init(params),
                 "step": jnp.zeros((), jnp.int32)}
        if jtcfg.ema_decay is not None:
            state["ema"] = jax.tree.map(jnp.copy, jdt._ema_subtree(params, frozen))
        losses = []
        with mesh:
            state = jdt.shard_diffusion_state(mesh, jtx, state)
            for i in range(len(s["imgs"])):
                state, m = step(state, jmesh.shard_batch(mesh, jnp.asarray(s["imgs"][i])),
                                s["key"])
                losses.append(float(m["loss"]))
        params = to_numpy_tree(state["params"])
        params.pop("prior", None)
        out[conf["name"]] = (np.asarray(losses), _flat(params))
    return out


@pytest.mark.parametrize("name", ["frozen", "cotrained"])
def test_stage2_model2_matches_jax_mesh_and_world1(ranks, jax_stage2, name):
    conf = next(c for c in STAGE2 if c["name"] == name)
    r0, r1 = (o["tp_steps"] for o in ranks["out"])
    params0 = _sub(r0, f"{name}/params")
    for k, v in params0.items():
        np.testing.assert_array_equal(v, r1[f"{name}/params/{k}"], err_msg=k)
    s = ranks["stage2"][name]
    tcfg = tdt.DiffusionTrainConfig(**conf["tcfg"])
    tx = tdt.make_two_group_optimizer(tcfg, conf["frozen"])
    bb = NFBackbone(tglow.GlowConfig(**dict(GLOW, **GLOW2)), IMG2, frozen=conf["frozen"])
    params = convert.diffusion_from_jax_params(s["tree"], s["tdp"], "cpu", requires_grad=True)
    params.pop("prior")
    state = {"params": params, "opt_state": tx.init(params), "step": 0}
    if tcfg.ema_decay is not None:
        state["ema"] = tdt._ema_copy(params, conf["frozen"])
    step = tdt.make_train_step(bb, s["tdp"], tcfg, tx, inject_noise=True, device="cpu")
    losses1 = []
    for i in range(len(s["imgs"])):
        state, m = step(state, s["imgs"][i], s["draws"][i])
        losses1.append(float(m["loss"]))
    world1 = _flat(convert.diffusion_to_jax_params(state["params"]))
    world1.pop("prior", None)
    jlosses, jparams = jax_stage2[name]
    for want_losses, want in ((jlosses, jparams), (np.asarray(losses1), world1)):
        np.testing.assert_allclose(r0[f"{name}/loss"], want_losses, rtol=1e-5, atol=0)
        _params_close(params0, want)
    if "ema" in state:  # the shadow's slabs, gathered, are one rank's shadow
        ema = {k: v for k, v in _sub(r0, f"{name}/ema").items()}
        want = {k: v for k, v in _flat(convert.map_tree(state["ema"], lambda t: t)).items()}
        assert ema.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(ema[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# Evaluation and sampling
# ---------------------------------------------------------------------------

def test_scoring_and_samplers_match_one_rank(ranks):
    out0, out1 = (o["evaluation"] for o in ranks["out"])
    cfg = tglow.GlowConfig(**GLOW)
    tcfg = tnft.NFTrainConfig()
    params = convert.from_jax_params(ranks["tree"], "cpu")
    loader = tpipe.read_dataset("synthetic", "", batch_size=8, img_size=8, seed=0,
                                synthetic_fallback=True, synthetic_n=24).test
    eval_step = tnft.make_eval_step(cfg, tcfg, "cpu")
    for k, iwae in ((1, False), (2, True)):
        want = tnft.calculate_bpd(eval_step, params, loader, 3, k, iwae)
        np.testing.assert_allclose(out0[f"bpd_k{k}"], want, rtol=BPD_TOL)
    glow = tnft.make_sample_fn(cfg, tcfg, 8, 3, "cpu")(params, 5, 0.8, 2).numpy()
    assert out0["glow_samples"].dtype == np.uint8
    assert np.abs(out0["glow_samples"].astype(int) - glow.astype(int)).max() <= 1
    tree2 = ranks["stage2"]["frozen"]["tree"]
    bb = NFBackbone(tglow.GlowConfig(**dict(GLOW, **GLOW2)), IMG2, frozen=True)
    for sampler, sampling_timesteps in (("ddim", 4), ("ddpm", 8)):
        dp = TDiffusionPrior(tfmt.IdentityFormater(L=2, in_channels=3, size=IMG2), dict(UNET),
                             dict(DIFF, sampling_timesteps=sampling_timesteps))
        p2 = convert.diffusion_from_jax_params(tree2, dp, "cpu")
        sample = inference.make_diffusion_sample_fn(bb, dp, 5, "cpu")
        _, latents = sample(p2, 3, generator=inference.reseed(torch.Generator(), 4, 1),
                            return_latents=True)
        for i, z in enumerate(latents):
            np.testing.assert_allclose(out0[f"{sampler}/z{i}"], z.numpy(), rtol=0, atol=1e-4)
            np.testing.assert_array_equal(out0[f"{sampler}/z{i}"], out1[f"{sampler}/z{i}"])
        if sampler == "ddim":
            loader2 = tpipe.read_dataset("synthetic", "", batch_size=4, img_size=IMG2, seed=0,
                                         synthetic_fallback=True, synthetic_n=8).test
            want = tdt.calculate_bpd_with_diff_prior(bb, dp, tdt.DiffusionTrainConfig(), p2,
                                                     loader2, 3, max_batches=1, device="cpu")
            np.testing.assert_allclose(out0["vlb"], want, rtol=1e-5)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("direction", ["model2_to_model1", "model1_to_model2"])
def test_cross_topology_resume(ranks, direction, tmp_path):
    """A checkpoint written at model 2 (whole tensors, rank 0) resumes at one
    rank, and one written at one rank resumes at model 2: both end where the
    uninterrupted one-rank run ends."""
    want = _flat(convert.to_jax_params(ranks["runs"]["uninterrupted"]["state"]["params"]))
    want_bpd = ranks["runs"]["uninterrupted"]["results"]
    if direction == "model1_to_model2":
        r0, r1 = (o["checkpoints"] for o in ranks["out"])
        got = {k: v for k, v in _sub(r0, "from_world1").items() if k != "bpd"}
        np.testing.assert_array_equal(r0["from_world1/bpd"], r1["from_world1/bpd"])
        bpd = r0["from_world1/bpd"]
    else:
        saved = torch.load(ranks["d"] / "first_epoch" / "checkpoints" / "model_gaussian_001.pt",
                           weights_only=True)
        for key in ("params", "opt_state"):  # the one-device layout: whole leaves
            tree = saved[key] if key == "params" else saved[key]["mu"]
            shapes = {k: tuple(v.shape) for k, v in convert.named_leaves(tree)}
            assert shapes["flow/blocks/0/steps/0/coupling/net/conv1/w"] == (16, 6, 3, 3)
        tcfg = tnft.NFTrainConfig(epochs=1, lr=1e-3, print_freq=100, save_checkpoint_freq=100)
        res = tnft.train(cfg=tglow.GlowConfig(**GLOW), tcfg=tcfg, loaders=_loaders(),
                         run_dir=str(tmp_path / "resumed"), logger=logging.getLogger("tp"),
                         seed=0, img_size=IMG, resume_dir=str(ranks["d"] / "first_epoch"),
                         resume_epoch=1, device="cpu")
        got = _flat(convert.to_jax_params(res["state"]["params"]))
        bpd = [res["results"]["bpd_test"], res["results"]["bpd_train"]]
    _params_close(got, want, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(bpd, [want_bpd["bpd_test"], want_bpd["bpd_train"]],
                               rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def test_entry_points_at_model2_match_one_process(ranks, monkeypatch, tmp_path):
    r0, r1 = (o["tp_entry"] for o in ranks["out"])
    for key in r0:
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("NFDPM_NO_TENSORBOARD", "1")
    s1 = run_baseline.main(["device=cpu", *SMALL, "experiment_name=s1_tp"])
    want = [s1["results"]["bpd_test"], s1["results"]["bpd_train"]]
    np.testing.assert_allclose(r0["stage1/bpd"], want, rtol=0, atol=BPD_TOL)
    np.testing.assert_allclose(r0["stage1_eval/bpd"], r0["stage1/bpd"], rtol=0, atol=BPD_TOL)
    s2 = run_diffusion_prior.main([a.replace("{stage1}", Path(s1["run_dir"]).name) for a in S2])
    np.testing.assert_allclose(r0["s2/vlb"], s2["vlb_bpd"], rtol=1e-5)
    np.testing.assert_allclose(r0["s2_eval/vlb"], r0["s2/vlb"], rtol=1e-5)
    log = (ranks["d"] / "outputs").glob("s1_tp_*/train.log")
    assert "Param shardings applied: model axis=2" in next(log).read_text()
