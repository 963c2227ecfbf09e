"""Stage-2 training of nfdpm_tpu_torch against nfdpm_tpu on the CPU.

The JAX package's `diffusion_trainer.make_train_step`, unchanged, runs five
steps from a seeded state; every draw it makes (the dequantization, and per
part the timesteps, the noise and the self-conditioning coin) is
recomputed from its keys and injected into the port's step, which starts
from the same state brought across by `convert` (parameters, both groups'
Adam moments and count, the EMA shadow). Glow L2/K1/w16 at 8x8x3, UNets of
dim 8 ([1, 2], 2 groups), T = 8, batch 4, the l1 loss of the config.

  (a) frozen flow, IdentityFormater (two UNets), EMA inside the step;
  (b) co-trained flow with its own learning rate and the flow's bits/dim
      term, CatFormater (one UNet), EMA every second step.

Each configuration compiles the JAX step once (module-scoped fixtures).
Pass criteria: per-step loss within 1e-4 relative; parameters and EMA after
step 5 within rtol 1e-4 / atol 1e-5; p_mat and sign (and in (a) every flow
leaf) unchanged. Then the optimizer's groups, checkpoints and resume, and
the entry point `python -m nfdpm_tpu_torch.run_diffusion_prior` on the CPU
(called in-process) from a stage-1 run of the port, with the flow frozen
and co-trained.
"""

import json
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (close, interrupt_loaders_after, jax_diffusion_draws, metric_overrides,
                         one_torch_thread, precompute_stats, randomize, to_numpy_tree)
from nfdpm_tpu.models import formaters as jfmt
from nfdpm_tpu.models import glow as jglow
from nfdpm_tpu.models.diffusion_prior import DiffusionPrior as JDiffusionPrior
from nfdpm_tpu.models.nf_backbone import NFBackbone as JBackbone
from nfdpm_tpu.training import diffusion_trainer as jdt
from nfdpm_tpu.training import optim as joptim
from nfdpm_tpu_torch import convert, run_baseline, run_diffusion_prior
from nfdpm_tpu_torch.models import formaters as tfmt
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.models.diffusion_prior import DiffusionPrior as TDiffusionPrior
from nfdpm_tpu_torch.models.nf_backbone import NFBackbone as TBackbone
from nfdpm_tpu_torch.models.nf_backbone import load_pretrained_flow
from nfdpm_tpu_torch.training import checkpoint as tckpt
from nfdpm_tpu_torch.training import diffusion_trainer as tdt
from nfdpm_tpu_torch.training import runload as trl

IMG, BATCH, STEPS = 16, 4, 5
GLOW = dict(in_channels=3, levels=2, steps=1, coupling_width=16)
UNET = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=2)
DIFF = dict(timesteps=8, sampling_timesteps=4, loss_type="l1", beta_schedule="cosine")
CONFIGS = {
    "frozen": dict(formater="IdentityFormater", frozen=True, ema_update_every=1),
    "cotrained": dict(formater="CatFormater", frozen=False, ema_update_every=2),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _zeros_like(tree):
    return jax.tree.map(lambda a: np.zeros(np.shape(a), np.float32), tree)


@pytest.fixture(scope="module", params=list(CONFIGS))
def trajectory(request):
    """Both frameworks' five steps of one configuration."""
    conf = CONFIGS[request.param]
    frozen = conf["frozen"]
    jformater = jfmt.get_formater(conf["formater"])(L=2, in_channels=3, size=IMG)
    tformater = tfmt.get_formater(conf["formater"])(L=2, in_channels=3, size=IMG)
    jdp = JDiffusionPrior(jformater, dict(UNET), dict(DIFF))
    tdp = TDiffusionPrior(tformater, dict(UNET), dict(DIFF))
    unets = {"parts": tuple(convert.unet_to_flax(u)
                            for u in tdp.init_params(2, "cpu")["parts"])}
    tree = randomize(to_numpy_tree({"flow": jglow.init_glow(0, jglow.GlowConfig(**GLOW)),
                                    "diffusion": unets}), seed=3, scale=0.02)
    kw = dict(lr_diffusion=1e-3, lr_nf=None if frozen else 3e-4, ema_decay=0.9,
              ema_update_every=conf["ema_update_every"])

    # JAX: the unchanged train step, its EMA every k steps as its trainer does
    jtcfg = jdt.DiffusionTrainConfig(**kw)
    jtx = jdt.make_two_group_optimizer(jtcfg, frozen)
    jbb = JBackbone(jglow.GlowConfig(**GLOW), IMG, frozen=frozen)
    params = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": params, "opt_state": jtx.init(params),
              "step": jnp.zeros((), jnp.int32),
              "ema": jax.tree.map(jnp.copy, jdt._ema_subtree(params, frozen))}
    jstep = jdt.make_train_step(jbb, jdp, jtcfg, jtx)
    jema = jdt.make_ema_update(jbb, jtcfg) if conf["ema_update_every"] > 1 else None
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (STEPS, BATCH, IMG, IMG, 3)).astype(np.float32) / 255.0
    key = jax.random.PRNGKey(11)
    shapes = [(BATCH, *s) for s in jformater.input_shapes]
    losses, draws = [], []
    for i in range(STEPS):
        draws.append(jax_diffusion_draws(key, i, jdp, shapes, (BATCH, IMG, IMG, 3)))
        jstate, metrics = jstep(jstate, jnp.asarray(imgs[i]), key)
        if jema is not None and (i + 1) % conf["ema_update_every"] == 0:
            jstate = jema(jstate)
        losses.append(float(metrics["loss"]))

    # the port, from the same state brought across
    tcfg = tdt.DiffusionTrainConfig(**kw)
    tx = tdt.make_two_group_optimizer(tcfg, frozen)
    tbb = TBackbone(tglow.GlowConfig(**GLOW), IMG, frozen=frozen)
    tparams = convert.diffusion_from_jax_params(tree, tdp, "cpu", requires_grad=True)
    tparams.pop("prior")
    moments = _zeros_like(tree)
    # the JAX step donates its state: the start is taken from the numpy tree
    ema = convert.diffusion_from_jax_params(jdt._ema_subtree(tree, frozen), tdp, "cpu")
    ema.pop("prior", None)
    state = {"params": tparams, "step": 0, "ema": ema,
             "opt_state": convert.opt_state_from_jax(moments, moments, 0, "cpu", dp=tdp)}
    step = tdt.make_train_step(tbb, tdp, tcfg, tx, inject_noise=True, device="cpu")
    ema_fn = tdt.make_ema_update(tbb, tcfg) if conf["ema_update_every"] > 1 else None
    tlosses = []
    for i in range(STEPS):
        state, metrics = step(state, imgs[i], draws[i])
        if ema_fn is not None and (i + 1) % conf["ema_update_every"] == 0:
            state = ema_fn(state)
        assert metrics["loss"].dim() == 0 and not metrics["loss"].requires_grad
        tlosses.append(float(metrics["loss"]))
    return dict(conf=conf, tree=tree, tdp=tdp, losses=losses, tlosses=tlosses,
                jstate=to_numpy_tree(jstate), state=state)


def test_losses_match_jax_step_by_step(trajectory):
    for got, want in zip(trajectory["tlosses"], trajectory["losses"]):
        assert math.isfinite(got) and abs(got - want) <= 1e-4 * abs(want), (got, want)


def _assert_close_trees(got, want):
    n = 0
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0], jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=str(path))
        n += 1
    assert n == len(jax.tree.leaves(want))


def test_parameters_and_ema_after_five_steps_match_jax(trajectory):
    s, j = trajectory["state"], trajectory["jstate"]
    assert s["step"] == STEPS and s["opt_state"]["count"] == STEPS
    got = convert.diffusion_to_jax_params(s["params"])
    _assert_close_trees(got["diffusion"], j["params"]["diffusion"])
    _assert_close_trees(got["flow"], j["params"]["flow"])
    ema = s["ema"]
    got_ema = convert.diffusion_to_jax_params(
        {"flow": ema.get("flow", s["params"]["flow"]), "diffusion": ema["diffusion"]})
    _assert_close_trees(got_ema["diffusion"], j["ema"]["diffusion"])
    if "flow" in j["ema"]:
        _assert_close_trees(got_ema["flow"], j["ema"]["flow"])
    # the moments cross back to the JAX layout
    mu, nu, count = convert.opt_state_to_jax(s["opt_state"], dp=trajectory["tdp"])
    assert count == STEPS and jax.tree.structure(mu) == jax.tree.structure(
        dict(trajectory["tree"], prior={}))


def test_frozen_leaves_do_not_move(trajectory):
    tree, state = trajectory["tree"], trajectory["state"]
    got = convert.diffusion_to_jax_params(state["params"])["flow"]
    frozen = trajectory["conf"]["frozen"]
    moved = 0
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(tree["flow"])):
        name = getattr(path[-1], "key", "")
        if frozen or name in ("p_mat", "sign"):
            np.testing.assert_array_equal(a, b, err_msg=str(path))
        else:
            moved += int(not np.array_equal(a, b))
    assert frozen or moved > 10  # the co-trained flow did move


# ---------------------------------------------------------------------------
# Optimizer groups, EMA warm-up, checkpoints and resume
# ---------------------------------------------------------------------------

def test_two_group_optimizer_learning_rates():
    base = dict(lr_diffusion=1e-3, lr_schedule="cosine", lr_decay_steps=10,
                lr_warmup_steps=2)
    frozen = tdt.make_two_group_optimizer(tdt.DiffusionTrainConfig(lr_nf=1e-4, **base), True)
    assert frozen.groups["flow"] is None and frozen.clip_value is None
    assert frozen.clip_norm is None
    no_lr = tdt.make_two_group_optimizer(tdt.DiffusionTrainConfig(**base), False)
    assert no_lr.groups["flow"] is None
    both = tdt.make_two_group_optimizer(tdt.DiffusionTrainConfig(lr_nf=1e-4, **base), False)
    assert not both.updates("flow/blocks/0/steps/0/invconv/p_mat")
    assert both.updates("diffusion/parts/0/init_conv.weight")
    for count in range(12):  # each group on the schedule at its own peak rate
        for group, lr in (("diffusion", 1e-3), ("flow", 1e-4)):
            want = float(joptim.make_lr_schedule(lr, "cosine", 2, 10, 0.0)(count))
            assert math.isclose(both.groups[group](count), want, rel_tol=1e-5,
                                abs_tol=1e-12)  # optax in fp32, the port in fp64
    with pytest.raises(ValueError):
        tdt.make_two_group_optimizer(tdt.DiffusionTrainConfig(optimizer="sgd"), True)


# ---------------------------------------------------------------------------
# The entry point on the CPU, from a stage-1 run of the port
# ---------------------------------------------------------------------------

SMALL = ["device=cpu", "data.name=synthetic", "data.batch_size=8", "data.img_size=8",
         "data.synthetic_n=32"]
STAGE2 = SMALL + ["model.unet.dim=8", "model.unet.dim_mults=[1,2]",
                  "model.unet.resnet_block_groups=2", "model.diffusion.timesteps=8",
                  "model.diffusion.sampling_timesteps=4", "model.training.print_freq=2",
                  "model.training.save_checkpoint_freq=1",
                  "model.logging.log_gen_images_per_iter=2", "model.evaluation.vlb_batches=1",
                  "model.training.ema_decay=0.9", "model.training.ema_update_every=2"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A directory holding outputs/<stage-1 run> (Glow L2/K1/w16, 8x8x3,
    one epoch, trained by run_baseline.main with device=cpu); returns
    (directory, the run's name)."""
    cwd = tmp_path_factory.mktemp("stage2_entry")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(cwd)
        mp.setenv("NFDPM_NO_TENSORBOARD", "1")
        run_baseline.main(SMALL + ["experiment_name=nf", "model.architecture.L=2",
                                   "model.architecture.K=1",
                                   "model.architecture.coupling_width=16",
                                   "model.training.epochs=1",
                                   "model.training.save_checkpoint_freq=1"])
    (run,) = (cwd / "outputs").iterdir()
    return cwd, run.name


def _stage2(workdir, *extra):
    cwd, nf_run = workdir
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(cwd)
        mp.setenv("NFDPM_NO_TENSORBOARD", "1")
        return run_diffusion_prior.main(
            STAGE2 + [f"model.normalizing_flow.init_nf.pretrain.dir={nf_run}",
                      "model.normalizing_flow.init_nf.pretrain.epoch=1", *extra])


@pytest.fixture(scope="module")
def two_epochs(workdir):
    """A two-epoch run, and one epoch plus a resume for the second."""
    full = _stage2(workdir, "experiment_name=full", "model.training.epochs=2")
    first = _stage2(workdir, "experiment_name=first", "model.training.epochs=1")
    resumed = _stage2(workdir, "experiment_name=resumed", "model.training.epochs=1",
                      f"load.load_exp_dir={first['run_dir'].split('/', 1)[1]}",
                      "load.load_epoch=1")
    return full, first, resumed


def test_train_phase_writes_the_run_directory(workdir, two_epochs):
    cwd, _ = workdir
    run = cwd / two_epochs[1]["run_dir"]
    arch = json.loads((run / "diffusion_architecture.json").read_text())
    assert arch["kind"] == "diffusion_prior" and arch["frozen"] is True
    assert arch["flow"] == {"L": 2, "K": 1, "in_channels": 3, "coupling_width": 16,
                            "learn_prior": True, "invconv_param": "plu", "img_size": 8}
    assert arch["formater"] == "IdentityFormater" and arch["formater_stats"] is None
    assert arch["unet_kwargs"]["dim_mults"] == [1, 2]
    assert (run / "checkpoints" / "model_diffusion_001.pt").exists()
    assert list((run / "results").glob("checkpoint_samples_e1_*.png"))
    assert "ema" in tckpt.checkpoint_keys(str(run), "diffusion", 1)
    res = two_epochs[1]
    assert math.isfinite(res["vlb_bpd"]) and res["vlb_n"] == 8


def test_two_epochs_equal_one_epoch_and_a_resume(workdir, two_epochs):
    cwd, _ = workdir
    full, _, resumed = two_epochs
    assert resumed["vlb_bpd"] == full["vlb_bpd"]
    a = torch.load(cwd / full["run_dir"] / "checkpoints" / "model_diffusion_002.pt")
    b = torch.load(cwd / resumed["run_dir"] / "checkpoints" / "model_diffusion_002.pt")
    assert a["step"] == b["step"] == 8 and a["opt_state"]["count"] == 8
    leaves_a = dict(convert.named_leaves(a))
    leaves_b = dict(convert.named_leaves(b))
    assert leaves_a.keys() == leaves_b.keys() and any(k.startswith("ema/") for k in leaves_a)
    for k in leaves_a:
        if isinstance(leaves_a[k], torch.Tensor):
            assert torch.equal(leaves_a[k], leaves_b[k]), k


def test_eval_phase_reproduces_the_vlb(workdir, two_epochs):
    full = two_epochs[0]
    again = _stage2(workdir, "experiment_name=eval", "phase=eval",
                    f"load.load_exp_dir={full['run_dir'].split('/', 1)[1]}", "load.load_epoch=2")
    assert again["vlb_bpd"] == full["vlb_bpd"]


def test_resume_keeps_drops_or_seeds_the_ema(workdir, two_epochs):
    cwd, nf_run = workdir
    run = str(cwd / two_epochs[1]["run_dir"])
    backbone, _ = load_pretrained_flow(str(cwd / "outputs" / nf_run), 1, device="cpu")
    tdp = TDiffusionPrior(tfmt.IdentityFormater(L=2, in_channels=3, size=8),
                          dict(UNET), dict(DIFF))
    kept = tdt.restore_train_state(run, 1, backbone, tdp, want_ema=True, device="cpu")
    dropped = tdt.restore_train_state(run, 1, backbone, tdp, want_ema=False, device="cpu")
    assert "ema" not in dropped and kept["step"] == 4
    ema_w = kept["ema"]["diffusion"]["parts"][0].init_conv.weight
    live_w = kept["params"]["diffusion"]["parts"][0].init_conv.weight
    assert not torch.equal(ema_w, live_w) and not ema_w.requires_grad
    # a checkpoint without an EMA, resumed with one: the shadow is seeded
    tree = torch.load(tckpt.checkpoint_path(run, "diffusion", 1))
    tree.pop("ema")
    torch.save(tree, tckpt.checkpoint_path(run, "diffusion", 9))
    seeded = tdt.restore_train_state(run, 9, backbone, tdp, want_ema=True, device="cpu")
    assert torch.equal(seeded["ema"]["diffusion"]["parts"][0].init_conv.weight,
                       seeded["params"]["diffusion"]["parts"][0].init_conv.weight)
    # eval reads the EMA weights where the run kept them
    params = tckpt.restore_params(run, "diffusion", 1, "cpu", prefer_ema=True)
    assert torch.equal(params["diffusion"]["parts"][0]["init_conv.weight"], ema_w)


COTRAIN = ["model.normalizing_flow.freeze=false", "model.normalizing_flow.lr=1e-4"]


@pytest.fixture(scope="module")
def cotrained(workdir):
    """The flow co-trained through the entry point: two epochs, one epoch
    plus a resume for the second, and phase=eval of the two-epoch run."""
    full = _stage2(workdir, "experiment_name=co_full", "model.training.epochs=2", *COTRAIN)
    first = _stage2(workdir, "experiment_name=co_first", "model.training.epochs=1", *COTRAIN)
    resumed = _stage2(workdir, "experiment_name=co_resumed", "model.training.epochs=1",
                      *COTRAIN, f"load.load_exp_dir={first['run_dir'].split('/', 1)[1]}",
                      "load.load_epoch=1")
    evaluated = _stage2(workdir, "experiment_name=co_eval", "phase=eval", *COTRAIN,
                        f"load.load_exp_dir={full['run_dir'].split('/', 1)[1]}",
                        "load.load_epoch=2")
    return full, first, resumed, evaluated


def test_cotrained_entry_point_moves_the_flow_and_logs_its_bpd(workdir, cotrained):
    """freeze=false with its own rate: the checkpoint's flow (and its EMA)
    moved from the stage-1 run, p_mat and sign did not, the stage-1 prior
    is not in the state, and the logged loss is l1_plus_bpd."""
    cwd, nf_run = workdir
    run = cwd / cotrained[1]["run_dir"]
    assert json.loads((run / "diffusion_architecture.json").read_text())["frozen"] is False
    names = [json.loads(line)["name"] for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert names.count("l1_plus_bpd") == 2 and "l1" not in names
    start = dict(convert.named_leaves(
        tckpt.restore_params(str(cwd / "outputs" / nf_run), "gaussian", 1, "cpu")["flow"]))
    tree = torch.load(tckpt.checkpoint_path(str(run), "diffusion", 1))
    assert "prior" not in tree["params"] and "flow" in tree["ema"]
    for flow in (tree["params"]["flow"], tree["ema"]["flow"]):
        moved = 0
        for path, leaf in convert.named_leaves(flow):
            if convert.is_frozen_path(path):
                assert torch.equal(leaf, start[path]), path
            else:
                moved += not torch.equal(leaf, start[path])
        assert moved > 10


def test_cotrained_two_epochs_equal_one_epoch_and_a_resume(workdir, cotrained):
    cwd, _ = workdir
    full, _, resumed, _ = cotrained
    assert resumed["vlb_bpd"] == full["vlb_bpd"]
    a = torch.load(cwd / full["run_dir"] / "checkpoints" / "model_diffusion_002.pt")
    b = torch.load(cwd / resumed["run_dir"] / "checkpoints" / "model_diffusion_002.pt")
    assert a["step"] == b["step"] == 8 and b["opt_state"]["count"] == 8
    leaves_a, leaves_b = dict(convert.named_leaves(a)), dict(convert.named_leaves(b))
    assert leaves_a.keys() == leaves_b.keys()
    assert any(k.startswith("opt_state/mu/flow/") for k in leaves_a)
    for k in leaves_a:
        if isinstance(leaves_a[k], torch.Tensor):
            assert torch.equal(leaves_a[k], leaves_b[k]), k


def test_cotrained_eval_reads_the_trained_flow(cotrained):
    """phase=eval takes the flow from the stage-2 checkpoint (its EMA), not
    from the stage-1 run: the same bound as the end of training."""
    full, _, _, evaluated = cotrained
    assert math.isfinite(full["vlb_bpd"]) and evaluated["vlb_bpd"] == full["vlb_bpd"]


@pytest.mark.parametrize("override,match", [
    # the ids are the cases' names from before the data axis was ported, when
    # both options were refused with "multi-GPU"; part_parallel is now refused
    # with a co-trained flow (the JAX package's rule), and the model axis
    # stays refused
    pytest.param("parallel.part_parallel=true model.normalizing_flow.freeze=false",
                 "requires a frozen flow", id="parallel.part_parallel=true-multi-GPU"),
    pytest.param("parallel.n_model=2", "tensor, pipeline and spatial",
                 id="parallel.fsdp=true-multi-GPU"),
    ("parallel.spatial=true", "tensor, pipeline and spatial"),
])
def test_refused_options_raise(workdir, override, match):
    with pytest.raises((NotImplementedError, ValueError), match=match):
        _stage2(workdir, "experiment_name=refused", *override.split())


@pytest.mark.parametrize("option", ["load.load_batch", "model.training.watchdog_timeout_s",
                                    "model.training.profile_epoch", "model.unet.dtype",
                                    "model.normalizing_flow.coupling_dtype"])
def test_accepted_options_do_their_job(workdir, two_epochs, monkeypatch, caplog, option):
    """The options the port once refused: `load.load_batch` resumes an
    interrupted epoch to the uninterrupted one-epoch run's checkpoint, bit
    for bit, and its VLB; the watchdog trains without firing;
    `profile_epoch` writes the epoch's trace, and the epoch's line its step
    times. The bf16 UNet (tests/test_entry_points.py:test_standardized_bf16_stage2):
    `model.diffusion.unet_dtype=bfloat16` with standardized latents trains,
    diffusion_architecture.json holds the dtype and the stats, `phase=eval`
    (with `model.unet.dtype`, the other key) reproduces the VLB and runload
    rebuilds bf16 UNets; the bf16 flow: `coupling_dtype=bfloat16` over the
    pretrained flow, co-trained, runs every flow forward in bf16, moves the
    flow, keeps the "flow" entry without a dtype, and `phase=eval` with it
    reproduces the VLB."""
    cwd, _ = workdir
    first = two_epochs[1]  # one epoch, uninterrupted
    one = ["model.training.epochs=1"]
    if option == "load.load_batch":
        restore = interrupt_loaders_after(monkeypatch, 2)
        with pytest.raises(KeyboardInterrupt):
            _stage2(workdir, "experiment_name=cut", *one)
        restore()
        (cut,) = (cwd / "outputs").glob("cut_*")
        assert tckpt.load_mid_epoch_marker(str(cut)) == {
            "prefix": "diffusion", "epoch": 1, "batch_in_epoch": 2}
        out = _stage2(workdir, "experiment_name=resumed_mid", *one,
                      f"load.load_exp_dir={cut.name}", "load.load_epoch=1",
                      "load.load_batch=2")
        assert out["vlb_bpd"] == first["vlb_bpd"]
        a = torch.load(cwd / first["run_dir"] / "checkpoints" / "model_diffusion_001.pt")
        b = torch.load(cwd / out["run_dir"] / "checkpoints" / "model_diffusion_001.pt")
        leaves_a, leaves_b = dict(convert.named_leaves(a)), dict(convert.named_leaves(b))
        assert leaves_a.keys() == leaves_b.keys() and b["step"] == 4
        for k in leaves_a:
            if isinstance(leaves_a[k], torch.Tensor):
                assert torch.equal(leaves_a[k], leaves_b[k]), k
    elif option == "model.unet.dtype":
        std = ["model.normalizing_flow.standardize_latents=true",
               "model.normalizing_flow.standardize_batches=2"]
        out = _stage2(workdir, "experiment_name=unet_bf16", *one, *std,
                      "model.diffusion.unet_dtype=bfloat16")
        run = cwd / out["run_dir"]
        arch = json.loads((run / "diffusion_architecture.json").read_text())
        assert arch["unet_kwargs"]["dtype"] == "bfloat16"
        stats = arch["formater_stats"]
        assert stats and all(len(m) == len(s) and all(v > 0 for v in s) for m, s in stats)
        assert math.isfinite(out["vlb_bpd"])
        evaluated = _stage2(workdir, "experiment_name=unet_bf16_eval", "phase=eval", *std,
                            f"load.load_exp_dir={run.name}", "load.load_epoch=1",
                            f"{option}=bfloat16")
        assert evaluated["vlb_bpd"] == out["vlb_bpd"]
        loaded = trl.load_diffusion_run(str(run), device="cpu")
        assert [[list(m), list(s)] for m, s in loaded.dp.formater.stats] == stats
        for unet in loaded.params["diffusion"]["parts"]:
            assert unet.dtype == unet.init_conv.dtype == torch.bfloat16
    elif option == "model.normalizing_flow.coupling_dtype":
        seen = []
        forward = tglow.forward
        monkeypatch.setattr(tglow, "forward",
                            lambda p, cfg, *a, **k: seen.append(cfg.compute_dtype)
                            or forward(p, cfg, *a, **k))
        cotrain = ["model.normalizing_flow.freeze=false", "model.normalizing_flow.lr=1e-4",
                   f"{option}=bfloat16"]
        out = _stage2(workdir, "experiment_name=flow_bf16", *one, *cotrain)
        assert seen and set(seen) == {torch.bfloat16}
        run = cwd / out["run_dir"]
        arch = json.loads((run / "diffusion_architecture.json").read_text())
        assert "coupling_dtype" not in arch["flow"] and arch["frozen"] is False
        assert math.isfinite(out["vlb_bpd"])
        start = tckpt.restore_params(str(cwd / "outputs" / workdir[1]), "gaussian", 1, "cpu")
        trained = torch.load(run / "checkpoints" / "model_diffusion_001.pt")
        moved = [k for k, v in convert.named_leaves(trained["params"]["flow"])
                 if isinstance(v, torch.Tensor) and not torch.equal(
                     v, dict(convert.named_leaves(start["flow"]))[k])]
        assert moved
        evaluated = _stage2(workdir, "experiment_name=flow_bf16_eval", "phase=eval", *cotrain,
                            f"load.load_exp_dir={run.name}", "load.load_epoch=1")
        assert evaluated["vlb_bpd"] == out["vlb_bpd"]
    elif option == "model.training.watchdog_timeout_s":
        out = _stage2(workdir, "experiment_name=wd", *one, f"{option}=300")
        assert out["vlb_bpd"] == first["vlb_bpd"]
        assert not (cwd / out["run_dir"] / "watchdog_stall.txt").exists()
    else:
        with caplog.at_level("INFO", logger="base"):
            out = _stage2(workdir, "experiment_name=prof", *one, f"{option}=1",
                          "model.training.profile_steps=2")
        trace = cwd / out["run_dir"] / "tb" / "profile" / "epoch_001.pt.trace.json"
        assert out["vlb_bpd"] == first["vlb_bpd"] and trace.stat().st_size > 0
        assert "profiler: 2 steps of epoch 1" in caplog.text
        assert re.search(r"step p50 [0-9.]+ms p95 [0-9.]+ms", caplog.text)


def test_configured_metrics_run(workdir, tmp_path, monkeypatch, caplog):
    """FID and KID in both modes and SSIM/PSNR on the EMA weights: at the
    checkpoint epoch and the end of `train`, then in phase=eval, under the
    JAX package's keys, finite; phase=eval samples what training's final
    evaluation sampled, so its FID/KID are the same."""
    precompute_stats(monkeypatch, tmp_path, 8)
    metrics = metric_overrides("FID", "KID", quick_num_gen=32)
    with caplog.at_level("INFO", logger="base"):
        trained = _stage2(workdir, "experiment_name=metrics", "model.training.epochs=1",
                          *metrics)
    keys = {"FID_inception", "FID_clean_inception", "KID_inception", "KID_clean_inception",
            "SSIM", "PSNR"}
    assert set(trained["metrics"]) == keys
    assert all(math.isfinite(v) for v in trained["metrics"].values())
    assert caplog.text.count("epoch 1 metrics: {") == 2
    run = trained["run_dir"].split("/")[-1]
    evaluated = _stage2(workdir, "experiment_name=metrics_eval", "phase=eval",
                        f"load.load_exp_dir={run}", "load.load_epoch=1", *metrics)["metrics"]
    assert set(evaluated) == keys and all(math.isfinite(v) for v in evaluated.values())
    for key in keys - {"SSIM", "PSNR"}:
        assert evaluated[key] == trained["metrics"][key], key


def test_orbax_run_directory_is_refused(tmp_path):
    (tmp_path / "checkpoints" / "model_gaussian_001").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="tools/jax_run_to_torch.py"):
        load_pretrained_flow(str(tmp_path), 1, device="cpu")


def test_a_frozen_backbone_keeps_no_graph_of_the_flow():
    cfg = tglow.GlowConfig(**GLOW)
    flow = convert.trainable(tglow.init_glow(0, cfg, "cpu"))
    x = torch.rand((2, IMG, IMG, 3), generator=torch.Generator().manual_seed(0)) - 0.5
    frozen, trained = TBackbone(cfg, IMG), TBackbone(cfg, IMG, frozen=False)
    latents_f, ldj_f = frozen.transform(flow, x)
    latents_t, ldj_t = trained.transform(flow, x)
    assert ldj_f.grad_fn is None and all(z.grad_fn is None for z in latents_f)
    assert ldj_t.grad_fn is not None and torch.equal(ldj_f, ldj_t.detach())
    assert all(not t.requires_grad for _, t in convert.named_leaves(frozen.maybe_freeze(flow)))
    assert trained.maybe_freeze(flow) is flow
    with torch.no_grad():
        back = frozen.sample(flow, latents_f)
    close(back, x.numpy(), atol=1e-4)


def test_latent_stats_are_fit_once_and_read_back(workdir):
    """standardize_latents=true: the stats are fit from the training stream,
    stored in diffusion_architecture.json under the JAX keys, and an
    evaluation of the run reads them back (the same bound again)."""
    cwd, _ = workdir
    trained = _stage2(workdir, "experiment_name=standardized", "model.training.epochs=1",
                      "model.normalizing_flow.standardize_latents=true",
                      "model.normalizing_flow.standardize_batches=2")
    arch = json.loads((cwd / trained["run_dir"] / "diffusion_architecture.json").read_text())
    stats = tfmt.stats_from_json(arch["formater_stats"])
    assert [len(mean) for mean, _ in stats] == [6, 24]
    assert all(s > 0 for _, std in stats for s in std)
    again = _stage2(workdir, "experiment_name=standardized_eval", "phase=eval",
                    f"load.load_exp_dir={trained['run_dir'].split('/', 1)[1]}",
                    "load.load_epoch=1")
    assert again["vlb_bpd"] == trained["vlb_bpd"]
