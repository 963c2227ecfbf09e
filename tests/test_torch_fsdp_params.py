"""Parameter partitioning over the data axis with gather-on-use
(`parallel.fsdp`, nfdpm_tpu_torch/parallel/zero.py) on four gloo ranks,
against nfdpm_tpu on the CPU: the counterparts of the JAX package's
tests/test_parallel.py fsdp tests.

One launch (tests/_torch_fsdp_scenarios.py: fsdp_steps, fsdp_data4; the
model axis's checkpoints and tp_entry, tests/_torch_tp_scenarios.py):
  * two stage-1 steps at (data 2, model 2) with fsdp, CFG_FSDP (L2/K2,
    width 128, 8x8x3, batch 16), the injected global noise, against the
    JAX package's fsdp step on make_mesh(n_data=2, n_model=2) and the port
    at one rank (bits/dim rtol 1e-5; parameters rtol 3e-4 / atol 1e-5
    after step 1, the trajectory bound rtol 1e-3 after step 2); each rank
    holds between steps the bytes the placements predict;
  * on a (4, 1) mesh: rank 0's parameter and moment bytes at most half of
    the replicated layout's and equal to predicted_param_bytes +
    predicted_moment_bytes; two steps of a flow whose small leaves lie whole
    on owners (FSDP_MIN_SIZE 16, K = 4 over 4 channels) against JAX and one
    rank; one stage-2 step with the frozen flow, the UNet and the EMA
    shadow partitioned against the JAX package's fsdp step on
    make_mesh(n_data=4) (loss rtol 1e-5, parameters rtol 1e-3 / atol 5e-4,
    its own bound) and the shadow against one rank's;
  * a cross-topology resume at (2, 2) with fsdp, both directions;
  * both entry points with parallel.fsdp=true at (2, 2) on tiny data against
    the same runs in one process, and their phase=eval.
"""

import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import (jax_diffusion_draws, one_torch_thread, randomize, run_ranks,
                         to_numpy_tree)
from nfdpm_tpu.models import formaters as jfmt
from nfdpm_tpu.models import glow as jglow
from nfdpm_tpu.models import prior as jprior
from nfdpm_tpu.models.diffusion_prior import DiffusionPrior as JDiffusionPrior
from nfdpm_tpu.models.nf_backbone import NFBackbone as JBackbone
from nfdpm_tpu.parallel import mesh as jmesh
from nfdpm_tpu.training import diffusion_trainer as jdt
from nfdpm_tpu.training import nf_trainer as jnft
from nfdpm_tpu.training import optim as joptim
from nfdpm_tpu_torch import convert, run_baseline, run_diffusion_prior
from nfdpm_tpu_torch.data import pipeline as tpipe
from nfdpm_tpu_torch.models import formaters as tfmt
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.models.diffusion_prior import DiffusionPrior as TDiffusionPrior
from nfdpm_tpu_torch.models.nf_backbone import NFBackbone
from nfdpm_tpu_torch.training import diffusion_trainer as tdt
from nfdpm_tpu_torch.training import nf_trainer as tnft

IMG, BATCH = 8, 16
GLOW = dict(in_channels=3, levels=2, steps=2, coupling_width=16, learn_prior=True)
FSDP_GLOW = dict(coupling_width=128)  # CFG_FSDP
OWNER_GLOW = dict(in_channels=1, steps=4, coupling_width=8)
STAGE2 = dict(img=8, glow=dict(steps=1, coupling_width=128),
              unet=dict(dim=64, dim_mults=(1,), resnet_block_groups=8),
              diff=dict(timesteps=4, beta_schedule="cosine", loss_type="l2"))
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
      "model.training.ema_decay=0.9", "experiment_name=s2_fsdp"]
FSDP = ["parallel.n_model=2", "parallel.fsdp=true"]


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
    return tpipe.read_dataset("synthetic", "", batch_size=8, img_size=IMG, seed=0,
                              synthetic_fallback=True, synthetic_n=32)


def _stage1_tree(cfg, seed):
    return randomize(to_numpy_tree({"flow": jglow.init_glow(0, cfg), "prior":
                                    jprior.init_gaussian_prior(tglow.final_channels(cfg),
                                                               True)}), seed=seed)


def _stage2_inputs():
    jcfg = jglow.GlowConfig(**dict(GLOW, **STAGE2["glow"]))
    size = STAGE2["img"]
    jformater = jfmt.IdentityFormater(L=2, in_channels=3, size=size)
    jdp = JDiffusionPrior(jformater, dict(STAGE2["unet"]), dict(STAGE2["diff"]))
    tdp = TDiffusionPrior(tfmt.IdentityFormater(L=2, in_channels=3, size=size),
                          dict(STAGE2["unet"]), dict(STAGE2["diff"]))
    unets = {"parts": tuple(convert.unet_to_flax(u) for u in tdp.init_params(2, "cpu")["parts"])}
    tree = randomize(to_numpy_tree({"flow": jglow.init_glow(0, jcfg), "diffusion": unets}),
                     seed=3, scale=0.02)
    imgs = np.random.default_rng(5).random((BATCH, size, size, 3)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    draws = jax_diffusion_draws(key, 0, jdp, [(BATCH, *s) for s in jformater.input_shapes],
                                (BATCH, size, size, 3))
    return dict(jcfg=jcfg, jdp=jdp, tdp=tdp, tree=tree, imgs=imgs, key=key, draws=draws)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp_params")
    rng = np.random.default_rng(11)
    inputs = {}
    for name, glow in (("fsdp", FSDP_GLOW), ("owner", OWNER_GLOW)):
        cfg = jglow.GlowConfig(**dict(GLOW, **glow))
        tree = _stage1_tree(cfg, seed=1)
        c = cfg.in_channels
        imgs = rng.integers(0, 256, (2, BATCH, IMG, IMG, c)).astype(np.float32) / 255.0
        noise = rng.random(imgs.shape).astype(np.float32)
        convert.save_npz(d / f"{name}_tree.npz", tree)
        np.savez(d / f"{name}.npz", imgs=imgs, noise=noise)
        inputs[name] = dict(tree=tree, imgs=imgs, noise=noise, cfg=cfg)
    s2 = _stage2_inputs()
    convert.save_npz(d / "fsdp2_tree.npz", s2["tree"])
    flat = {"imgs": s2["imgs"], "dequant": s2["draws"]["dequant"]}
    for j, part in enumerate(s2["draws"]["parts"]):
        flat.update({f"t_{j}": part["t"], f"noise_{j}": part["noise"],
                     f"coin_{j}": np.asarray(part["self_cond"])})
    np.savez(d / "fsdp2.npz", **flat)
    runs = {}
    for name, epochs in (("world1_run", 1), ("uninterrupted", 2)):
        tcfg = tnft.NFTrainConfig(epochs=epochs, lr=1e-3, print_freq=100,
                                  save_checkpoint_freq=100)
        runs[name] = tnft.train(cfg=tglow.GlowConfig(**GLOW), tcfg=tcfg, loaders=_loaders(),
                                run_dir=str(d / name), logger=logging.getLogger("fsdp"), seed=0,
                                img_size=IMG, device="cpu")
    job = {"scenarios": ["fsdp_steps", "fsdp_data4", "checkpoints", "tp_entry"], "n_model": 2,
           "fsdp_min_size": 256, "glow": GLOW, "fsdp_glow": FSDP_GLOW,
           "owner_glow": OWNER_GLOW, "fsdp_stage2": STAGE2, "fsdp": True,
           "entry": {"stage1": ["device=cpu", *SMALL, "experiment_name=s1_fsdp", *FSDP],
                     "stage2": {"s2": S2 + FSDP}}}
    out = run_ranks(job, 4, d, timeout_s=240.0)
    return dict(d=d, inputs=inputs, s2=s2, out=out, runs=runs)


def _jax_stage1(inp, mesh=None):
    """The JAX step, on `mesh` with fsdp (the JAX package's own minimum
    size) or on one device: bits/dim and parameters after each step."""
    tx = joptim.make_optimizer("adam", 1e-3, fixed_prior=True)
    step = jnft.make_train_step(inp["cfg"], jnft.NFTrainConfig(lr=1e-3), tx, inject_noise=True)
    params = jax.tree.map(jnp.asarray, inp["tree"])
    state = {"params": params, "opt_state": tx.init(params), "step": jnp.zeros((), jnp.int32)}
    out = {"bpd": []}
    with mesh if mesh is not None else _nothing():
        if mesh is not None:
            state = jnft.shard_nf_state(mesh, tx, state, fsdp=True)
        for i in range(len(inp["imgs"])):
            batch = jnp.asarray(inp["imgs"][i])
            if mesh is not None:
                batch = jmesh.shard_batch(mesh, batch)
            state, m = step(state, batch, jnp.asarray(inp["noise"][i]))
            out["bpd"].append(float(m["bpd"]))
            out[f"step{i + 1}"] = _flat(to_numpy_tree(state["params"]))
    return out


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _world1_stage1(inp):
    cfg = tglow.GlowConfig(**dict(GLOW, **({"coupling_width": inp["cfg"].coupling_width,
                                            "in_channels": inp["cfg"].in_channels,
                                            "steps": inp["cfg"].steps})))
    tcfg = tnft.NFTrainConfig(lr=1e-3)
    tx = tnft.optimizer_of(tcfg)
    params = convert.trainable(convert.from_jax_params(inp["tree"], "cpu"))
    state = {"params": params, "opt_state": tx.init(params), "step": 0}
    step = tnft.make_train_step(cfg, tcfg, tx, inject_noise=True, device="cpu")
    out = {"bpd": []}
    for i in range(len(inp["imgs"])):
        state, m = step(state, inp["imgs"][i], inp["noise"][i])
        out["bpd"].append(float(m["bpd"]))
        out[f"step{i + 1}"] = _flat(convert.to_jax_params(state["params"]))
    return out


def _trajectory_close(got_bpd, got, want):
    np.testing.assert_allclose(got_bpd[0], want["bpd"][0], rtol=BPD_TOL)
    np.testing.assert_allclose(got_bpd, want["bpd"], rtol=TRAJ_RTOL)
    _params_close(got("step1"), want["step1"])
    _params_close(got("step2"), want["step2"], rtol=TRAJ_RTOL)


def test_fsdp_train_step_matches_single_device(ranks):
    """(data 2, model 2) with fsdp: the JAX package's fsdp step and one
    rank's, with parameters and moments partitioned over the data axis and
    exactly the placements' bytes held between steps."""
    inp = ranks["inputs"]["fsdp"]
    outs = [o["fsdp_steps"] for o in ranks["out"]]
    for out in outs[1:]:
        for k in outs[0]:
            if k.startswith(("step", "bpd")):
                np.testing.assert_array_equal(out[k], outs[0][k], err_msg=k)
    for want in (_jax_stage1(inp, jmesh.make_mesh(n_data=2, n_model=2)), _world1_stage1(inp)):
        _trajectory_close(outs[0]["bpd"], lambda s: _sub(outs[0], s), want)
    for out in outs:
        assert out["placed"] > 0
        for key in ("bytes", "bytes_after"):
            params, predicted, moments, predicted_moments = out[key]
            assert params == predicted and moments == predicted_moments, key


def test_fsdp_partitions_device_memory(ranks):
    """On (4, 1): rank 0's parameters and moments at most half of the
    replicated layout's, and exactly the placements' prediction."""
    rep = ranks["out"][0]["fsdp_data4"]["memory/fsdp0"]
    params, predicted, moments, predicted_moments = ranks["out"][0]["fsdp_data4"]["memory/fsdp1"]
    assert params == predicted and moments == predicted_moments
    assert params + moments <= (rep[0] + rep[2]) / 2.0, (params + moments, rep)


def test_fsdp_owner_placements_match_single_device(ranks):
    """Leaves whose largest axis is K lie whole on one rank (a broadcast on
    use, a reduce of the gradient): two steps follow JAX and one rank."""
    inp = ranks["inputs"]["owner"]
    outs = [o["fsdp_data4"] for o in ranks["out"]]
    assert outs[0]["owner/placed_whole"] > 0
    assert sum(int(o["owner/held_whole"]) for o in outs) == outs[0]["owner/placed_whole"]
    for out in outs[1:]:
        np.testing.assert_array_equal(out["owner/bpd"], outs[0]["owner/bpd"])
    for want in (_jax_stage1(inp), _world1_stage1(inp)):
        np.testing.assert_allclose(outs[0]["owner/bpd"][0], want["bpd"][0], rtol=BPD_TOL)
        np.testing.assert_allclose(outs[0]["owner/bpd"], want["bpd"], rtol=TRAJ_RTOL)
        _params_close(_sub(outs[0], "owner/params"), want["step2"], rtol=TRAJ_RTOL)


@pytest.fixture(scope="module")
def jax_stage2(ranks):
    s2 = ranks["s2"]
    jtcfg = jdt.DiffusionTrainConfig(epochs=1, lr_diffusion=1e-3)
    jtx = jdt.make_two_group_optimizer(jtcfg, frozen=True)
    step = jdt.make_train_step(JBackbone(s2["jcfg"], STAGE2["img"], frozen=True), s2["jdp"],
                               jtcfg, jtx)
    params = jax.tree.map(jnp.asarray, s2["tree"])
    state = {"params": params, "opt_state": jtx.init(params), "step": jnp.zeros((), jnp.int32)}
    mesh = jmesh.make_mesh(n_data=4, n_model=1)
    with mesh:
        state = jdt.shard_diffusion_state(mesh, jtx, state, fsdp=True)
        state, m = step(state, jmesh.shard_batch(mesh, jnp.asarray(s2["imgs"])), s2["key"])
    return float(m["loss"]), _flat(to_numpy_tree(state["params"]["diffusion"]))


def test_fsdp_diffusion_state_and_step(ranks, jax_stage2):
    """(4, 1) with fsdp: the frozen flow, the UNet and the EMA shadow
    partitioned (their bytes the placements'), and the step the JAX
    package's fsdp step; the shadow one rank's."""
    s2 = ranks["s2"]
    outs = [o["fsdp_data4"] for o in ranks["out"]]
    for out in outs:
        assert out["stage2/flow_placed"] > 0 and out["stage2/unet_placed"] > 0
        params, predicted, moments, predicted_moments = out["stage2/bytes"]
        assert params == predicted and moments == predicted_moments
        held_ema, predicted_ema = out["stage2/ema_bytes"]
        assert held_ema == predicted_ema
    jloss, jparams = jax_stage2
    np.testing.assert_allclose(outs[0]["stage2/loss"], jloss, rtol=1e-5)
    _params_close(_sub(outs[0], "stage2/params"), jparams, rtol=1e-3, atol=5e-4)
    # one rank's step and shadow, the same draws
    tcfg = tdt.DiffusionTrainConfig(lr_diffusion=1e-3, ema_decay=0.9, ema_update_every=1)
    tx = tdt.make_two_group_optimizer(tcfg, True)
    bb = NFBackbone(tglow.GlowConfig(**dict(GLOW, **STAGE2["glow"])), STAGE2["img"],
                    frozen=True)
    params = convert.diffusion_from_jax_params(s2["tree"], s2["tdp"], "cpu", requires_grad=True)
    params.pop("prior")
    state = {"params": params, "opt_state": tx.init(params), "step": 0,
             "ema": tdt._ema_copy(params, True)}
    step = tdt.make_train_step(bb, s2["tdp"], tcfg, tx, inject_noise=True, device="cpu")
    state, m = step(state, s2["imgs"], s2["draws"])
    np.testing.assert_allclose(outs[0]["stage2/loss"], float(m["loss"]), rtol=1e-5)
    _params_close(_sub(outs[0], "stage2/ema"), _flat(convert.map_tree(state["ema"],
                                                                      lambda t: t)),
                  rtol=1e-3, atol=5e-4)


@pytest.mark.parametrize("direction", ["fsdp_to_world1", "world1_to_fsdp"])
def test_cross_topology_resume(ranks, direction, tmp_path):
    """A checkpoint written at (2, 2) with fsdp (whole tensors, rank 0)
    resumes at one rank, and one written at one rank resumes at (2, 2) with
    fsdp: both end where the uninterrupted one-rank run ends."""
    want = _flat(convert.to_jax_params(ranks["runs"]["uninterrupted"]["state"]["params"]))
    want_bpd = ranks["runs"]["uninterrupted"]["results"]
    if direction == "world1_to_fsdp":
        outs = [o["checkpoints"] for o in ranks["out"]]
        for out in outs[1:]:
            np.testing.assert_array_equal(out["from_world1/bpd"], outs[0]["from_world1/bpd"])
        got = {k: v for k, v in _sub(outs[0], "from_world1").items() if k != "bpd"}
        bpd = outs[0]["from_world1/bpd"]
    else:
        tcfg = tnft.NFTrainConfig(epochs=1, lr=1e-3, print_freq=100, save_checkpoint_freq=100)
        res = tnft.train(cfg=tglow.GlowConfig(**GLOW), tcfg=tcfg, loaders=_loaders(),
                         run_dir=str(tmp_path / "resumed"), logger=logging.getLogger("fsdp"),
                         seed=0, img_size=IMG, resume_dir=str(ranks["d"] / "first_epoch"),
                         resume_epoch=1, device="cpu")
        got = _flat(convert.to_jax_params(res["state"]["params"]))
        bpd = [res["results"]["bpd_test"], res["results"]["bpd_train"]]
    _params_close(got, want, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(bpd, [want_bpd["bpd_test"], want_bpd["bpd_train"]],
                               rtol=0, atol=1e-4)


def test_entry_points_with_fsdp_match_one_process(ranks, monkeypatch, tmp_path):
    """run_baseline.main and run_diffusion_prior.main (with an EMA) with
    parallel.fsdp=true at (2, 2): the final numbers of the same runs in one
    process, and their phase=eval in the launch repeats them."""
    outs = [o["tp_entry"] for o in ranks["out"]]
    for out in outs[1:]:
        for key in outs[0]:
            np.testing.assert_array_equal(out[key], outs[0][key], err_msg=key)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("NFDPM_NO_TENSORBOARD", "1")
    s1 = run_baseline.main(["device=cpu", *SMALL, "experiment_name=s1_fsdp"])
    want = [s1["results"]["bpd_test"], s1["results"]["bpd_train"]]
    np.testing.assert_allclose(outs[0]["stage1/bpd"], want, rtol=0, atol=BPD_TOL)
    np.testing.assert_allclose(outs[0]["stage1_eval/bpd"], outs[0]["stage1/bpd"], rtol=0,
                               atol=BPD_TOL)
    s2 = run_diffusion_prior.main([a.replace("{stage1}", Path(s1["run_dir"]).name) for a in S2])
    np.testing.assert_allclose(outs[0]["s2/vlb"], s2["vlb_bpd"], rtol=1e-5)
    np.testing.assert_allclose(outs[0]["s2_eval/vlb"], outs[0]["s2/vlb"], rtol=1e-5)
    log = next((ranks["d"] / "outputs").glob("s1_fsdp_*/train.log")).read_text()
    assert "Param shardings applied: model axis=2, FSDP over data axis" in log
