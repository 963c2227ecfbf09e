"""The pipeline over K (nfdpm_tpu_torch/parallel/pipeline.py) on four gloo
ranks, against nfdpm_tpu on the CPU: the counterparts of the JAX package's
tests/test_pipeline.py.

One launch (tests/_torch_pipeline_scenarios.py: pp_forward, pp_steps; the
model axis's checkpoints and tp_entry, tests/_torch_tp_scenarios.py):
  * pp_forward on (1, 4) and (2, 2) meshes, M = 4, against JAX
    glow.forward (latents rtol/atol 1e-5, logdet and logp rtol 1e-5 / atol
    1e-4); one microbatch on both meshes and one stage on (4, 1) too;
  * two pipelined Adam steps at (2, 2) and (1, 4), M = 4, against the JAX
    step and the port at one rank (bits/dim rtol 1e-5, parameters rtol
    3e-4 / atol 1e-5);
  * a stage's flow parameters and moments at K = 4 over S = 4 under a third
    of the whole flow's, and every rank's bytes the placements' prediction;
  * a cross-topology resume, pipeline -> world 1 and world 1 -> pipeline;
  * run_baseline.main with parallel.n_model=2 parallel.pipeline=true on
    tiny data against the same run in one process, and its phase=eval.
In this process: the guards and the exclusions with the JAX package's
messages, and the pipeline without a model axis (a warning, the plain
step). Glow L2/K4, width 16, 8x8x3, batch 16 (resume and entry: L2/K2,
batch 8, M = 2).
"""

import logging
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import one_torch_thread, randomize, run_ranks, to_numpy_tree
from _torch_pipeline_scenarios import FORWARD_MESHES
from nfdpm_tpu.models import glow as jglow
from nfdpm_tpu.models import prior as jprior
from nfdpm_tpu.training import nf_trainer as jnft
from nfdpm_tpu.training import optim as joptim
from nfdpm_tpu_torch import convert, run_baseline
from nfdpm_tpu_torch.data import pipeline as tpipe
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.parallel import pipeline as tpl
from nfdpm_tpu_torch.training import nf_trainer as tnft

IMG, BATCH = 8, 16
PP_GLOW = dict(in_channels=3, levels=2, steps=4, coupling_width=16, learn_prior=True)
GLOW = dict(in_channels=3, levels=2, steps=2, coupling_width=16, learn_prior=True)
RTOL, ATOL, BPD_TOL, TRAJ_RTOL = 3e-4, 1e-5, 1e-5, 1e-3
SMALL = ["data.name=synthetic", "data.synthetic_fallback=true", "data.batch_size=8",
         "data.img_size=8", "data.synthetic_n=32", "model.architecture.L=2",
         "model.architecture.K=2", "model.architecture.coupling_width=16",
         "model.training.epochs=1", "model.training.save_checkpoint_freq=1",
         "model.training.print_freq=2"]
PIPE = ["parallel.n_model=2", "parallel.pipeline=true"]


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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline")
    jcfg = jglow.GlowConfig(**PP_GLOW)
    tree = randomize(to_numpy_tree({"flow": jglow.init_glow(0, jcfg),
                                    "prior": jprior.init_gaussian_prior(24, True)}), seed=1)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(BATCH, IMG, IMG, 3)).astype(np.float32)
    imgs = rng.integers(0, 256, (2, BATCH, IMG, IMG, 3)).astype(np.float32) / 255.0
    noise = rng.random(imgs.shape).astype(np.float32)
    convert.save_npz(d / "pp_tree.npz", tree)
    np.savez(d / "pp_x.npz", x=x)
    np.savez(d / "pp_steps.npz", imgs=imgs, noise=noise)
    runs = {}
    for name, epochs in (("world1_run", 1), ("uninterrupted", 2)):
        tcfg = tnft.NFTrainConfig(epochs=epochs, lr=1e-3, print_freq=100,
                                  save_checkpoint_freq=100)
        runs[name] = tnft.train(cfg=tglow.GlowConfig(**GLOW), tcfg=tcfg, loaders=_loaders(),
                                run_dir=str(d / name), logger=logging.getLogger("pp"), seed=0,
                                img_size=IMG, device="cpu")
    job = {"scenarios": ["pp_forward", "pp_steps", "checkpoints", "tp_entry"], "n_model": 2,
           "glow": GLOW, "pp_glow": PP_GLOW, "pipeline_microbatches": 2,
           "entry": {"stage1": ["device=cpu", *SMALL, "experiment_name=s1_pp", *PIPE],
                     "stage2": {}}}
    out = run_ranks(job, 4, d, timeout_s=240.0)
    return dict(d=d, tree=tree, x=x, imgs=imgs, noise=noise, out=out, runs=runs)


@pytest.fixture(scope="module")
def jax_forward(ranks):
    params = jax.tree.map(jnp.asarray, ranks["tree"]["flow"])
    latents, ldj, logp = jax.jit(lambda p, x: jglow.forward(p, jglow.GlowConfig(**PP_GLOW), x))(
        params, jnp.asarray(ranks["x"]))
    return [np.asarray(z) for z in latents], np.asarray(ldj), np.asarray(logp)


def _forward_close(ranks, jax_forward, n_model, microbatches, ldj_only=False):
    latents, ldj, logp = jax_forward
    tag = f"m{n_model}_mb{microbatches}"
    for out in ranks["out"]:
        o = out["pp_forward"]
        data_rank, n = o[f"{tag}/rows"]
        rows = slice(data_rank * n, (data_rank + 1) * n)
        np.testing.assert_allclose(o[f"{tag}/ldj"], ldj[rows], rtol=1e-5, atol=1e-4)
        if ldj_only:
            continue
        np.testing.assert_allclose(o[f"{tag}/logp"], logp[rows], rtol=1e-5, atol=1e-4)
        for i, z in enumerate(latents):
            np.testing.assert_allclose(o[f"{tag}/z{i}"], z[rows], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_model", [4, 2])
def test_pp_forward_matches_plain(ranks, jax_forward, n_model):
    """pp_forward over 4 microbatches on the stages of a (1, 4) and a (2, 2)
    mesh is JAX glow.forward: latents, logdet and split-prior logp."""
    _forward_close(ranks, jax_forward, n_model, 4)


@pytest.mark.parametrize("n_model,microbatches", [(1, 2), (4, 1), (2, 1)])
def test_pp_single_stage_and_single_microbatch(ranks, jax_forward, n_model, microbatches):
    """Degenerate schedules, one stage (no hops) or one microbatch, still
    give the plain forward."""
    assert (n_model, microbatches) in FORWARD_MESHES
    _forward_close(ranks, jax_forward, n_model, microbatches, ldj_only=True)


@pytest.fixture(scope="module")
def single_device(ranks):
    """Two steps of the JAX step and of the port at one rank, the same noise."""
    jcfg = jglow.GlowConfig(**PP_GLOW)
    tx = joptim.make_optimizer("adam", 1e-3, fixed_prior=True)
    step = jnft.make_train_step(jcfg, jnft.NFTrainConfig(lr=1e-3), tx, inject_noise=True)
    params = jax.tree.map(jnp.asarray, ranks["tree"])
    state = {"params": params, "opt_state": tx.init(params), "step": jnp.zeros((), jnp.int32)}
    tcfg = tnft.NFTrainConfig(lr=1e-3)
    ttx = tnft.optimizer_of(tcfg)
    tparams = convert.trainable(convert.from_jax_params(ranks["tree"], "cpu"))
    tstate = {"params": tparams, "opt_state": ttx.init(tparams), "step": 0}
    tstep = tnft.make_train_step(tglow.GlowConfig(**PP_GLOW), tcfg, ttx, inject_noise=True,
                                 device="cpu")
    out = {"jax": {"bpd": []}, "world1": {"bpd": []}}
    for i in range(len(ranks["imgs"])):
        state, m = step(state, jnp.asarray(ranks["imgs"][i]), jnp.asarray(ranks["noise"][i]))
        out["jax"]["bpd"].append(float(m["bpd"]))
        out["jax"][f"step{i + 1}"] = _flat(to_numpy_tree(state["params"]))
        tstate, m = tstep(tstate, ranks["imgs"][i], ranks["noise"][i])
        out["world1"]["bpd"].append(float(m["bpd"]))
        out["world1"][f"step{i + 1}"] = _flat(convert.to_jax_params(tstate["params"]))
    return out


@pytest.mark.parametrize("n_model", [2, 4])
def test_pp_train_step_matches_single_device(ranks, single_device, n_model):
    """Two pipelined Adam steps (M = 4) follow the JAX step's and one rank's
    trajectory: bits/dim and the updated parameters; every rank gathers the
    same parameters."""
    outs = [o["pp_steps"] for o in ranks["out"]]
    tag = f"m{n_model}"
    for out in outs[1:]:
        for k in outs[0]:
            if k.startswith((f"{tag}/step", f"{tag}/bpd")):
                np.testing.assert_array_equal(out[k], outs[0][k], err_msg=k)
    for want in single_device.values():
        np.testing.assert_allclose(outs[0][f"{tag}/bpd"], want["bpd"], rtol=BPD_TOL)
        for s in ("step1", "step2"):
            _params_close(_sub(outs[0], f"{tag}/{s}"), want[s])


def test_pipeline_config_guards():
    """The JAX package's guards and exclusions, with its messages."""
    cfg = tglow.GlowConfig(**PP_GLOW)
    with pytest.raises(ValueError, match="divisible by the"):
        tpl.check_pipeline_config(tglow.GlowConfig(**dict(PP_GLOW, steps=3)), 4, 4, 8)
    with pytest.raises(ValueError, match="pipeline_microbatches"):
        tpl.check_pipeline_config(cfg, 4, 0, 8)
    with pytest.raises(ValueError, match="divisible by"):
        tpl.check_pipeline_config(cfg, 4, 3, 8)
    tpl.check_pipeline_config(cfg, 4, 4, 8)
    with pytest.raises(ValueError, match="at most one"):
        tpl.check_exclusive(True, spatial=True)
    tx = tnft.optimizer_of(tnft.NFTrainConfig())
    state = tnft.init_train_state(0, cfg, tnft.NFTrainConfig(), tx, "cpu")
    mesh = SimpleNamespace(n_data=2, n_model=4)  # refused before the mesh is read
    with pytest.raises(ValueError, match="at most one"):
        tnft.shard_nf_state(mesh, tx, state, fsdp=True, pipeline=True)
    # a stage holds steps [s K/S, (s+1) K/S) of every level, the splits none
    placements = tpl.glow_pp_placements(state["params"]["flow"], 2)
    assert placements and not any("split" in p for p in placements)
    for path, pl in placements.items():
        k = int(path.split("steps/")[1].split("/")[0])
        assert (pl.dim, pl.owner) == (None, k // 2), path


def test_pipeline_partitions_flow_memory(ranks):
    """K = 4 over S = 4: a stage's flow parameters and moments under a third
    of the whole flow's; at (2, 2) and (1, 4) every rank holds the bytes the
    placements predict."""
    for out in ranks["out"]:
        o = out["pp_steps"]
        held, whole = o["m4/bytes"][:2]
        assert held < whole / 3.0, (held, whole)
        for n_model in (2, 4):
            params, predicted, moments, predicted_moments = o[f"m{n_model}/bytes"][2:]
            assert params == predicted and moments == predicted_moments, n_model


@pytest.mark.parametrize("direction", ["pipeline_to_world1", "world1_to_pipeline"])
def test_cross_topology_resume(ranks, direction, tmp_path):
    """A checkpoint written under the pipeline at (2, 2) (whole tensors, rank
    0) resumes at one rank, and one written at one rank resumes under the
    pipeline: both end where the uninterrupted one-rank run ends."""
    want = _flat(convert.to_jax_params(ranks["runs"]["uninterrupted"]["state"]["params"]))
    want_bpd = ranks["runs"]["uninterrupted"]["results"]
    if direction == "world1_to_pipeline":
        outs = [o["checkpoints"] for o in ranks["out"]]
        for out in outs[1:]:
            np.testing.assert_array_equal(out["from_world1/bpd"], outs[0]["from_world1/bpd"])
        got = {k: v for k, v in _sub(outs[0], "from_world1").items() if k != "bpd"}
        bpd = outs[0]["from_world1/bpd"]
    else:
        tcfg = tnft.NFTrainConfig(epochs=1, lr=1e-3, print_freq=100, save_checkpoint_freq=100)
        res = tnft.train(cfg=tglow.GlowConfig(**GLOW), tcfg=tcfg, loaders=_loaders(),
                         run_dir=str(tmp_path / "resumed"), logger=logging.getLogger("pp"),
                         seed=0, img_size=IMG, resume_dir=str(ranks["d"] / "first_epoch"),
                         resume_epoch=1, device="cpu")
        got = _flat(convert.to_jax_params(res["state"]["params"]))
        bpd = [res["results"]["bpd_test"], res["results"]["bpd_train"]]
    _params_close(got, want, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(bpd, [want_bpd["bpd_test"], want_bpd["bpd_train"]],
                               rtol=0, atol=1e-4)


def test_entry_point_with_the_pipeline_matches_one_process(ranks, monkeypatch, tmp_path):
    """run_baseline.main with parallel.n_model=2 parallel.pipeline=true at
    (2, 2): the final bits/dim of the same run in one process, and its
    phase=eval in the launch repeats them."""
    outs = [o["tp_entry"] for o in ranks["out"]]
    for out in outs[1:]:
        for key in outs[0]:
            np.testing.assert_array_equal(out[key], outs[0][key], err_msg=key)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("NFDPM_NO_TENSORBOARD", "1")
    s1 = run_baseline.main(["device=cpu", *SMALL, "experiment_name=s1_pp"])
    want = [s1["results"]["bpd_test"], s1["results"]["bpd_train"]]
    np.testing.assert_allclose(outs[0]["stage1/bpd"], want, rtol=0, atol=BPD_TOL)
    np.testing.assert_allclose(outs[0]["stage1_eval/bpd"], outs[0]["stage1/bpd"], rtol=0,
                               atol=BPD_TOL)
    log = next((ranks["d"] / "outputs").glob("s1_pp_*/train.log")).read_text()
    assert "Pipeline parallelism: K=2 over 2 stages, 2 microbatches" in log
    assert "(pipeline layout)" in log


def test_pipeline_without_a_model_axis_warns_and_trains_the_plain_step(
        monkeypatch, tmp_path, caplog):
    """As in the JAX package: parallel.pipeline=true in one process (no model
    axis) logs its warning and trains the plain step, to the same numbers."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("NFDPM_NO_TENSORBOARD", "1")
    plain = run_baseline.main(["device=cpu", *SMALL, "experiment_name=plain"])
    piped = run_baseline.main(["device=cpu", *SMALL, "experiment_name=piped",
                               "parallel.pipeline=true"])
    assert piped["results"] == plain["results"]
    assert "parallel.pipeline has no effect without a model axis" in caplog.text
