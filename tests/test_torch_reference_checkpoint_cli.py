"""The checkpoint-interchange commands of nfdpm_tpu_torch, and the Adam state
that tools/jax_run_to_torch.py carries, against nfdpm_tpu on the CPU.

  1. A checkpoint in the original PyTorch repository's format (written with
     torch.save from the JAX package's export of seeded, perturbed weights;
     a Glow L2/K2, coupling width 16, 8x8x3) is converted by the JAX tool
     (tools/convert_reference_checkpoint.py) and by the port's command
     (python -m nfdpm_tpu_torch.convert_reference_checkpoint): the same
     architecture.json, the same parameters through convert, a fresh Adam
     state. Each run then resumes one epoch of 4 steps through its own
     entry point (run_baseline_experiment.main, nfdpm_tpu_torch.run_baseline
     .main) with the same injected dequantization noise: bits/dim of each
     step within 5e-5, tests/test_torch_train.py's trajectory gate.
  2. The export commands (tools/export_reference_checkpoint.py and python
     -m nfdpm_tpu_torch.export_reference_checkpoint) on that JAX run and on
     its port conversion: the same keys, shapes and dtypes, values within
     1e-6, the resume alias, current_iter 0; a stage-2 run is refused.
  3. tools/jax_run_to_torch.py on JAX runs trained a few steps: a stage-1
     run with a warmup schedule, and a co-trained stage-2 run (two Adam
     groups, EMA). The converted moments and count equal optax's exactly;
     the port resumes from the converted run with the JAX run's draws and
     stays within the trajectory gates (stage 1: 5e-5 bits/dim a step;
     stage 2: tests/test_torch_diffusion_train.py's 1e-4 relative loss).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (REPO_ROOT, RUN_DATA, RUN_GLOW, RUN_IMG, _write_config, adam_moments,
                         jax_diffusion_draws, one_torch_thread, randomize, to_numpy_tree)
from nfdpm_tpu.models import formaters as jfmt
from nfdpm_tpu.models import glow as jglow
from nfdpm_tpu.models import prior as jprior
from nfdpm_tpu.models.diffusion_prior import DiffusionPrior as JDiffusionPrior
from nfdpm_tpu.models.nf_backbone import NFBackbone as JBackbone
from nfdpm_tpu.training import checkpoint as jckpt
from nfdpm_tpu.training import diffusion_trainer as jdt
from nfdpm_tpu.training import nf_trainer as jnft
from nfdpm_tpu.training import optim as joptim
from nfdpm_tpu.utils import reference_export as jexport
from nfdpm_tpu_torch import convert, convert_reference_checkpoint, export_reference_checkpoint
from nfdpm_tpu_torch import run_baseline
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.training import checkpoint as tckpt
from nfdpm_tpu_torch.training import diffusion_trainer as tdt
from nfdpm_tpu_torch.training import nf_trainer as tnft
from nfdpm_tpu_torch.training import runload as trl

sys.path.insert(0, str(REPO_ROOT))
sys.path.insert(0, str(REPO_ROOT / "tools"))
import jax_run_to_torch  # noqa: E402
import run_baseline_experiment  # noqa: E402
from tools import convert_reference_checkpoint as jconvert_tool  # noqa: E402
from tools import export_reference_checkpoint as jexport_tool  # noqa: E402

BPD_STEP_TOL = 5e-5
CURRENT_ITER = 12
ARCH_ARGS = ["--L", str(RUN_GLOW["levels"]), "--K", str(RUN_GLOW["steps"]), "--in_channels", "3",
             "--img_size", str(RUN_IMG), "--coupling_width", str(RUN_GLOW["coupling_width"]),
             "--epoch", "1"]
ENTRY = RUN_DATA + [f"model.architecture.L={RUN_GLOW['levels']}",
                    f"model.architecture.K={RUN_GLOW['steps']}",
                    f"model.architecture.coupling_width={RUN_GLOW['coupling_width']}",
                    "model.training.epochs=1", "model.training.print_freq=100",
                    "model.training.save_checkpoint_freq=50", "load.load_epoch=1"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _noise(step, shape):
    """The dequantization draw of train step `step`, the same in both packages."""
    return np.random.default_rng(1000 + int(step)).random(shape, dtype=np.float32)


def _named(tree):
    return {k: (v.detach().contiguous().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in convert.named_leaves(tree) if not isinstance(v, int)}


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """A reference .pt and its two conversions, under <cwd>/outputs:
    (cwd, the JAX export of the weights, {"jax": run dir, "port": run dir})."""
    cwd = tmp_path_factory.mktemp("reference")
    cfg = jglow.GlowConfig(**RUN_GLOW)
    tree = randomize(to_numpy_tree({
        "flow": jglow.init_glow(0, cfg),
        "prior": jprior.init_gaussian_prior(tglow.final_channels(tglow.GlowConfig(**RUN_GLOW)),
                                            True)}), seed=6, scale=0.03)
    flow_sd = jexport.export_glow_state_dict(tree["flow"], cfg.levels, cfg.steps)
    as_torch = lambda sd: {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    pt = cwd / "model_gaussian_001.pt"
    torch.save({"flow": as_torch(flow_sd),
                "prior_dist": as_torch(jexport.export_gaussian_prior_state_dict(tree["prior"])),
                "optimizer": jexport.adam_skeleton(flow_sd, 1e-4),
                "current_iter": CURRENT_ITER}, pt)
    runs = {"jax": cwd / "outputs" / "ref_jax", "port": cwd / "outputs" / "ref_port"}
    argv = sys.argv
    try:
        sys.argv = ["convert_reference_checkpoint.py", "--checkpoint", str(pt),
                    "--out", str(runs["jax"]), *ARCH_ARGS]
        jconvert_tool.main()
    finally:
        sys.argv = argv
    record = convert_reference_checkpoint.main(["--checkpoint", str(pt), "--out",
                                                str(runs["port"]), *ARCH_ARGS])
    assert record["step"] == CURRENT_ITER
    return cwd, flow_sd, {k: str(v) for k, v in runs.items()}


# -- 1. reference .pt -> run directory --------------------------------------------

def test_both_conversions_write_the_same_run(imported):
    _, _, runs = imported
    arch = [json.load(open(os.path.join(runs[k], "architecture.json"))) for k in ("jax", "port")]
    assert arch[0] == arch[1]
    want = _named(convert.from_jax_params(jckpt.restore_params(runs["jax"], "gaussian", 1),
                                          "cpu"))
    got = tckpt.restore_state(runs["port"], "gaussian", 1, "cpu")
    assert got["step"] == CURRENT_ITER
    got_params = _named(got["params"])
    assert got_params.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got_params[k], v, err_msg=k)
    # a fresh Adam state over the same leaves
    assert got["opt_state"]["count"] == 0
    for moment in ("mu", "nu"):
        leaves = _named(got["opt_state"][moment])
        assert leaves.keys() == want.keys()
        assert all(not a.any() for a in leaves.values())


def test_the_port_command_refuses_what_weights_only_refuses(tmp_path):
    pt = tmp_path / "pickled.pt"
    torch.save({"flow": {}, "prior_dist": {}, "current_iter": 0, "extra": object()}, pt)
    with pytest.raises(Exception, match="[Ww]eights only"):
        convert_reference_checkpoint.main(["--checkpoint", str(pt), "--out",
                                           str(tmp_path / "run"), *ARCH_ARGS])


def _resume(monkeypatch, cwd, package, run_name):
    """One epoch resumed from `run_name` through the package's entry point,
    every step's dequantization draw _noise(step); returns the steps'
    bits/dim."""
    module = jnft if package == "jax" else tnft
    real = module.make_train_step
    bpds = []

    def injected(cfg, tcfg, tx, **kw):
        kw.pop("inject_noise", None)
        step = real(cfg, tcfg, tx, inject_noise=True, **kw)

        def train_step(state, batch, _key_or_seed):
            noise = _noise(state["step"], tuple(batch.shape))
            state, metrics = step(state, batch, jnp.asarray(noise) if package == "jax" else noise)
            bpds.append(float(metrics["bpd"]))
            return state, metrics

        return train_step

    monkeypatch.setattr(module, "make_train_step", injected)
    monkeypatch.chdir(cwd)
    monkeypatch.setenv("NFDPM_NO_TENSORBOARD", "1")
    argv = ENTRY + [f"experiment_name=resume_{package}", f"load.load_exp_dir={run_name}"]
    if package == "jax":
        run_baseline_experiment.main(argv)
    else:
        run_baseline.main(argv + ["device=cpu"])
    monkeypatch.undo()
    return bpds


def test_both_imported_runs_resume_on_the_same_trajectory(imported, monkeypatch):
    cwd, _, runs = imported
    bpd_j = _resume(monkeypatch, cwd, "jax", os.path.basename(runs["jax"]))
    bpd_t = _resume(monkeypatch, cwd, "port", os.path.basename(runs["port"]))
    assert len(bpd_j) == len(bpd_t) == 4 and np.all(np.isfinite(bpd_t))
    gaps = np.abs(np.array(bpd_t) - np.array(bpd_j))
    assert gaps.max() < BPD_STEP_TOL, gaps


# -- 2. run directory -> reference .pt --------------------------------------------

def test_export_commands_agree_on_a_jax_run_and_its_conversion(imported, tmp_path):
    _, flow_sd, runs = imported
    converted = tmp_path / "converted"
    jax_run_to_torch.main(["--run-dir", runs["jax"], "--out", str(converted)])
    # a run the JAX import tool wrote has no config.yaml: Adam, fixed prior, fresh
    assert tckpt.restore_state(str(converted), "gaussian", 1, "cpu")["opt_state"]["count"] == 0
    jexport_tool.main(["--run-dir", runs["jax"], "--out", str(tmp_path / "jax")])
    record = export_reference_checkpoint.main(["--run-dir", str(converted), "--out",
                                               str(tmp_path / "port"), "--device", "cpu"])
    assert record["epoch"] == 1
    want = torch.load(tmp_path / "jax" / "model_gaussian_001.pt", weights_only=False)
    got = torch.load(tmp_path / "port" / "model_gaussian_001.pt", weights_only=True)
    alias = torch.load(tmp_path / "port" / "model_001.pt", weights_only=True)
    assert set(got) == set(want) == set(alias) == {"flow", "prior_dist", "optimizer",
                                                   "current_iter"}
    assert got["current_iter"] == want["current_iter"] == 0
    assert got["optimizer"] == want["optimizer"]
    for part in ("flow", "prior_dist"):
        assert list(got[part]) == list(want[part])
        for k, v in want[part].items():
            assert got[part][k].dtype == v.dtype and got[part][k].shape == v.shape, k
            np.testing.assert_allclose(got[part][k].numpy(), v.numpy(), atol=1e-6, rtol=0,
                                       err_msg=k)
            assert torch.equal(alias[part][k], got[part][k]), k
    # and the weights are those of the reference checkpoint the run came from
    for k, v in flow_sd.items():
        np.testing.assert_allclose(got["flow"][k].numpy(), v, atol=1e-6, rtol=0, err_msg=k)


def test_export_refuses_a_stage_2_run(tmp_path):
    """A run directory with only model_diffusion_* checkpoints is refused
    before anything is loaded."""
    run = tmp_path / "stage2"
    (run / "checkpoints").mkdir(parents=True)
    torch.save({"params": {}, "step": 0}, run / "checkpoints" / "model_diffusion_001.pt")
    with pytest.raises(SystemExit, match="stage-2"):
        export_reference_checkpoint.main(["--run-dir", str(run), "--device", "cpu"])


# -- 3. Adam state of converted JAX runs -------------------------------------------

SAVED_AT, MORE_STEPS, BATCH = 2, 3, 8


def _compare_moments(got, want_mu, want_nu):
    for moment, want in ((got[0], want_mu), (got[1], want_nu)):
        flat_got = dict(jax.tree_util.tree_flatten_with_path(moment)[0])
        for path, v in jax.tree_util.tree_flatten_with_path(want)[0]:
            np.testing.assert_array_equal(flat_got[path], v,
                                          err_msg=jax.tree_util.keystr(path))


def test_stage_1_run_with_warmup_resumes_in_the_port(tmp_path):
    jax_dir, port_dir = tmp_path / "warmup_jax", tmp_path / "warmup_port"
    jax_dir.mkdir()
    warmup = 4
    cfg = jglow.GlowConfig(**RUN_GLOW)
    jckpt.save_architecture(str(jax_dir), {
        "L": cfg.levels, "K": cfg.steps, "in_channels": 3, "img_size": RUN_IMG,
        "coupling_width": cfg.coupling_width, "learn_prior": True, "n_bits": 5,
        "fixed_prior": True, "temperature": 0.7, "optimizer": "adam", "invconv_param": "plu"})
    _write_config(jax_dir, "nf_base.yaml", RUN_DATA + [
        f"model.architecture.L={cfg.levels}", f"model.architecture.K={cfg.steps}",
        f"model.architecture.coupling_width={cfg.coupling_width}",
        f"model.optimizer.warmup_steps={warmup}"])
    tree = randomize(to_numpy_tree({
        "flow": jglow.init_glow(0, cfg),
        "prior": jprior.init_gaussian_prior(tglow.final_channels(tglow.GlowConfig(**RUN_GLOW)),
                                            True)}), seed=8, scale=0.03)
    tx = joptim.make_optimizer("adam", 1e-3, fixed_prior=True,
                               lr_schedule=joptim.make_lr_schedule(1e-3, "constant", warmup))
    params = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": params, "opt_state": tx.init(params), "step": jnp.zeros((), jnp.int32)}
    jstep = jnft.make_train_step(cfg, jnft.NFTrainConfig(lr=1e-3), tx, inject_noise=True)
    rng = np.random.default_rng(9)
    imgs = rng.integers(0, 256, (SAVED_AT + MORE_STEPS, BATCH, RUN_IMG, RUN_IMG, 3))
    imgs = imgs.astype(np.float32) / 255.0
    bpd_j = []
    for i in range(SAVED_AT + MORE_STEPS):
        if i == SAVED_AT:  # the JAX step donates its state: save a host copy
            snapshot = to_numpy_tree(jstate)
            jckpt.save_state(str(jax_dir), "gaussian", 1, snapshot)
            mu_j, nu_j, count_j = adam_moments(snapshot["opt_state"], tree)
            jstate = jax.tree.map(jnp.asarray, snapshot)
        jstate, metrics = jstep(jstate, jnp.asarray(imgs[i]),
                                jnp.asarray(_noise(i, imgs[i].shape)))
        bpd_j.append(float(metrics["bpd"]))

    record = jax_run_to_torch.main(["--run-dir", str(jax_dir), "--out", str(port_dir)])
    assert record["optimizer_state"] == "Adam moments and count"
    state = tckpt.restore_state(str(port_dir), "gaussian", 1, "cpu")
    assert state["step"] == SAVED_AT and state["opt_state"]["count"] == count_j == SAVED_AT
    _compare_moments(convert.opt_state_to_jax(state["opt_state"]), mu_j, nu_j)

    tcfg = tnft.NFTrainConfig(lr=1e-3, lr_warmup_steps=warmup)
    tx_t = tnft.optimizer_of(tcfg)
    step = tnft.make_train_step(tglow.GlowConfig(**RUN_GLOW), tcfg, tx_t, inject_noise=True,
                                device="cpu")
    gaps = []
    for i in range(SAVED_AT, SAVED_AT + MORE_STEPS):
        state, metrics = step(state, imgs[i], _noise(i, imgs[i].shape))
        gaps.append(abs(float(metrics["bpd"]) - bpd_j[i]))
    assert max(gaps) < BPD_STEP_TOL, gaps
    assert state["opt_state"]["count"] == SAVED_AT + MORE_STEPS


S2_IMG, S2_BATCH = 16, 4
S2_GLOW = dict(in_channels=3, levels=2, steps=1, coupling_width=16)
S2_UNET = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=2)
S2_DIFF = dict(timesteps=8, sampling_timesteps=4, loss_type="l1", beta_schedule="cosine",
               ddim_sampling_eta=1.0, scan_unroll=1, sampling_method="auto", vlb_time_chunk=4)
S2_FORMATER = "CatFormater"


def test_cotrained_stage_2_run_resumes_in_the_port(tmp_path):
    jax_dir, port_dir = tmp_path / "cotrained_jax", tmp_path / "cotrained_port"
    jax_dir.mkdir()
    arch = {"kind": "diffusion_prior",
            "flow": dict(L=2, K=1, in_channels=3, coupling_width=16, learn_prior=True,
                         invconv_param="plu", img_size=S2_IMG),
            "formater": S2_FORMATER, "formater_stats": None,
            "unet_kwargs": dict(S2_UNET, dim_mults=[1, 2], learned_sinusoidal_cond=False,
                                random_fourier_features=False, learned_sinusoidal_dim=16),
            "diffusion_kwargs": dict(S2_DIFF), "frozen": False, "n_bits": 5,
            "temperature": 1.0}
    jckpt.save_architecture(str(jax_dir), arch, filename="diffusion_architecture.json")
    _write_config(jax_dir, "nf_diffusion.yaml", [
        "data.name=synthetic", f"data.img_size={S2_IMG}", f"data.batch_size={S2_BATCH}",
        "model.normalizing_flow.init_nf.mode=scratch", "model.normalizing_flow.freeze=false",
        "model.normalizing_flow.lr=3e-4", f"model.normalizing_flow.latent_formater={S2_FORMATER}",
        "model.normalizing_flow.init_nf.scratch.L=2", "model.normalizing_flow.init_nf.scratch.K=1",
        "model.normalizing_flow.init_nf.scratch.coupling_width=16", "model.unet.dim=8",
        "model.unet.dim_mults=[1,2]", "model.unet.resnet_block_groups=2",
        "model.diffusion.timesteps=8", "model.diffusion.sampling_timesteps=4",
        "model.training.ema_decay=0.9", "model.training.ema_update_every=1"])

    backbone_t, dp_t = trl.build_diffusion_model(arch)
    unets = {"parts": tuple(convert.unet_to_flax(u) for u in dp_t.init_params(2, "cpu")["parts"])}
    tree = randomize(to_numpy_tree({"flow": jglow.init_glow(0, jglow.GlowConfig(**S2_GLOW)),
                                    "diffusion": unets}), seed=3, scale=0.02)
    kw = dict(lr_diffusion=1e-3, lr_nf=3e-4, ema_decay=0.9, ema_update_every=1)
    jtcfg = jdt.DiffusionTrainConfig(**kw)
    jtx = jdt.make_two_group_optimizer(jtcfg, frozen=False)
    jformater = jfmt.get_formater(S2_FORMATER)(L=2, in_channels=3, size=S2_IMG)
    jdp = JDiffusionPrior(jformater, dict(S2_UNET), dict(timesteps=8, sampling_timesteps=4,
                                                         loss_type="l1", beta_schedule="cosine"))
    jbb = JBackbone(jglow.GlowConfig(**S2_GLOW), S2_IMG, frozen=False)
    params = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": params, "opt_state": jtx.init(params), "step": jnp.zeros((), jnp.int32),
              "ema": jax.tree.map(jnp.copy, jdt._ema_subtree(params, False))}
    jstep = jdt.make_train_step(jbb, jdp, jtcfg, jtx)
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (SAVED_AT + MORE_STEPS, S2_BATCH, S2_IMG, S2_IMG, 3))
    imgs = imgs.astype(np.float32) / 255.0
    key = jax.random.PRNGKey(11)
    shapes = [(S2_BATCH, *s) for s in jformater.input_shapes]
    losses, draws = [], []
    for i in range(SAVED_AT + MORE_STEPS):
        if i == SAVED_AT:
            snapshot = to_numpy_tree(jstate)
            jckpt.save_state(str(jax_dir), "diffusion", 1, snapshot)
            # one Adam state a group (optax.masked over multi_transform)
            groups = snapshot["opt_state"].inner_state.inner_states
            want = {g: adam_moments(groups[g], tree) for g in ("diffusion", "flow")}
            jstate = jax.tree.map(jnp.asarray, snapshot)
        draws.append(jax_diffusion_draws(key, i, jdp, shapes, (S2_BATCH, S2_IMG, S2_IMG, 3)))
        jstate, metrics = jstep(jstate, jnp.asarray(imgs[i]), key)
        losses.append(float(metrics["loss"]))

    jax_run_to_torch.main(["--run-dir", str(jax_dir), "--out", str(port_dir)])
    state = tdt.restore_train_state(str(port_dir), 1, backbone_t, dp_t, want_ema=True,
                                    device="cpu")
    assert state["step"] == SAVED_AT and set(state["ema"]) == {"flow", "diffusion"}
    mu, nu, count = convert.opt_state_to_jax(state["opt_state"], dp=dp_t)
    assert count == want["diffusion"][2] == want["flow"][2] == SAVED_AT
    for group in ("diffusion", "flow"):
        _compare_moments(({group: mu[group]}, {group: nu[group]}),
                         {group: want[group][0][group]}, {group: want[group][1][group]})

    tcfg = tdt.DiffusionTrainConfig(**kw)
    step = tdt.make_train_step(backbone_t, dp_t, tcfg, tdt.make_two_group_optimizer(tcfg, False),
                               inject_noise=True, device="cpu")
    for i in range(SAVED_AT, SAVED_AT + MORE_STEPS):
        state, metrics = step(state, imgs[i], draws[i])
        assert abs(float(metrics["loss"]) - losses[i]) <= 1e-4 * abs(losses[i]), (i, losses)
    assert state["opt_state"]["count"] == SAVED_AT + MORE_STEPS
