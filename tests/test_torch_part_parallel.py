"""Part-parallel stage 2 of nfdpm_tpu_torch against nfdpm_tpu on the CPU.

  * The port's part step against the JAX package's make_part_train_step,
    from the same state, on the JAX step's own draws (injected): losses and
    the part's parameters after three steps within the stage-2 bound of
    tests/test_torch_diffusion_train.py (1e-4 relative; rtol 1e-4 / atol
    1e-5).
  * The port's PartParallelPlan on one process against the port's joint
    trainer on the same batches, bit for bit: per-part losses, parameters
    and EMA shadows (the JAX package's
    test_part_parallel_bit_matches_joint_trainer).
  * Two parts on two gloo ranks (one group each) against the plan on one
    rank running both groups in turn: the same losses and merged
    parameters, bit for bit.
  * train_part_parallel resumed from its per-group checkpoint: bit for bit
    the uninterrupted run (parameters, moments, EMA and the merged view).
  * The JAX package's refusals: a co-trained flow, fsdp, load.load_batch.
Glow L2/K1/w16, IdentityFormater (two parts), UNets of dim 8 at 16x16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_diffusion_draws, one_torch_thread, randomize, run_ranks, to_numpy_tree
from nfdpm_tpu.models import formaters as jfmt
from nfdpm_tpu.models import glow as jglow
from nfdpm_tpu.models.diffusion_prior import DiffusionPrior as JDiffusionPrior
from nfdpm_tpu.models.nf_backbone import NFBackbone as JBackbone
from nfdpm_tpu.parallel import part_parallel as jpp
from nfdpm_tpu.training import diffusion_trainer as jdt
from nfdpm_tpu_torch import convert, run_diffusion_prior
from nfdpm_tpu_torch.models import formaters as tfmt
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.models.diffusion_prior import DiffusionPrior as TDiffusionPrior
from nfdpm_tpu_torch.models.nf_backbone import NFBackbone as TBackbone
from nfdpm_tpu_torch.parallel import part_parallel as tpp
from nfdpm_tpu_torch.training import diffusion_trainer as tdt

IMG, BATCH = 16, 4
GLOW = dict(in_channels=3, levels=2, steps=1, coupling_width=16)
UNET = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=2)
DIFF = dict(timesteps=8, sampling_timesteps=4, loss_type="l1", beta_schedule="cosine")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _priors():
    tdp = TDiffusionPrior(tfmt.IdentityFormater(L=2, in_channels=3, size=IMG), dict(UNET),
                          dict(DIFF))
    jdp = JDiffusionPrior(jfmt.IdentityFormater(L=2, in_channels=3, size=IMG), dict(UNET),
                          dict(DIFF))
    return tdp, jdp


def _batches(n, seed=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, BATCH, IMG, IMG, 3)).astype(np.float32) / 255.0


def _flat(tree):
    out = {}
    convert._flatten(tree, "", out)
    return {k: np.array(v) for k, v in out.items()}


@pytest.mark.parametrize("part", [0, 1])
def test_part_step_matches_jax(part):
    tdp, jdp = _priors()
    # the start of tests/test_torch_diffusion_train.py's frozen trajectory
    unets = {"parts": tuple(convert.unet_to_flax(u) for u in tdp.init_params(2, "cpu")["parts"])}
    joint = randomize(to_numpy_tree({"flow": jglow.init_glow(0, jglow.GlowConfig(**GLOW)),
                                     "diffusion": unets}), seed=3, scale=0.02)
    tree = {"flow": joint["flow"], "part": joint["diffusion"]["parts"][part]}
    tcfg_kw = dict(lr_diffusion=1e-3, ema_decay=0.9, ema_update_every=1)
    # JAX: its part step from the tree
    jtcfg = jdt.DiffusionTrainConfig(**tcfg_kw)
    jtx = jpp.make_part_optimizer(jtcfg)
    params = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": params, "opt_state": jtx.init(params["part"]),
              "step": jnp.zeros((), jnp.int32), "ema": jax.tree.map(jnp.copy, params["part"])}
    jstep = jpp.make_part_train_step(JBackbone(jglow.GlowConfig(**GLOW), IMG, frozen=True),
                                     jdp, part, jtcfg, jtx)
    imgs, key = _batches(3), jax.random.PRNGKey(11)
    shapes = [(BATCH, *s) for s in jdp.formater.input_shapes]
    jlosses, draws = [], []
    for i in range(3):
        draws.append(jax_diffusion_draws(key, i, jdp, shapes, (BATCH, IMG, IMG, 3)))
        jstate, loss = jstep(jstate, jnp.asarray(imgs[i]), key)
        jlosses.append(float(loss))
    # the port's, from the same tree, on the same draws
    tcfg = tdt.DiffusionTrainConfig(**tcfg_kw)
    tx = tpp.make_part_optimizer(tcfg)
    state = tpp.init_part_state(0, tdp, part, convert.from_jax_params(
        {"flow": tree["flow"], "prior": {}}, "cpu")["flow"], tx, ema=True, device="cpu")
    for target in (state["params"]["diffusion"]["parts"][0],
                   state["ema"]["diffusion"]["parts"][0]):
        with torch.no_grad():
            convert.unet_from_flax(target, tree["part"])
    step = tpp.make_part_train_step(TBackbone(tglow.GlowConfig(**GLOW), IMG, frozen=True), tdp,
                                    part, tcfg, tx, device="cpu", inject_noise=True)
    for i in range(3):
        state, loss = step(state, imgs[i], draws[i])
        assert abs(float(loss) - jlosses[i]) <= 1e-4 * abs(jlosses[i])
    got = _flat(convert.unet_to_flax(state["params"]["diffusion"]["parts"][0]))
    want = _flat(to_numpy_tree(jstate["params"]["part"]))
    got_ema = _flat(convert.unet_to_flax(state["ema"]["diffusion"]["parts"][0]))
    want_ema = _flat(to_numpy_tree(jstate["ema"]))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got_ema[k], want_ema[k], rtol=1e-4, atol=1e-5, err_msg=k)
    assert state["step"] == 3 and state["opt_state"]["count"] == 3


def _plan_and_joint(tcfg_kw, n_batches=3):
    tdp, _ = _priors()
    cfg = tglow.GlowConfig(**GLOW)
    flow = tglow.init_glow(0, cfg, "cpu")
    backbone = TBackbone(cfg, IMG, frozen=True)
    tcfg = tdt.DiffusionTrainConfig(**tcfg_kw)
    tx = tdt.make_two_group_optimizer(tcfg, True)
    joint = tdt.init_train_state(0, backbone, flow, tdp, tx, ema=tcfg.ema_decay is not None,
                                 device="cpu")
    jstep = tdt.make_train_step(backbone, tdp, tcfg, tx, device="cpu")
    ema_fn = (tdt.make_ema_update(backbone, tcfg) if tcfg.ema_update_every > 1 else None)
    plan = tpp.PartParallelPlan.build(0, backbone, flow, tdp, tcfg, device="cpu")
    imgs = _batches(n_batches)
    for i, b in enumerate(imgs):
        joint, m = jstep(joint, b, 7)
        if ema_fn is not None and (i + 1) % tcfg.ema_update_every == 0:
            joint = ema_fn(joint)
        losses = plan.step_all([b, b], 7)
        np.testing.assert_array_equal(m["part_losses"].numpy(),
                                      np.asarray([float(x) for x in losses]),
                                      err_msg=f"per-part losses diverged at step {i}")
    return joint, plan


@pytest.mark.parametrize("ema_update_every", [1, 2])
def test_plan_on_one_process_is_the_joint_trainer_bit_for_bit(ema_update_every):
    joint, plan = _plan_and_joint(dict(lr_diffusion=1e-2, ema_decay=0.5,
                                       ema_update_every=ema_update_every))
    for prefer_ema, tree in ((False, joint["params"]), (True, joint["ema"])):
        merged = plan.joint_params(prefer_ema=prefer_ema)
        for a, b in zip(merged["diffusion"]["parts"], tree["diffusion"]["parts"]):
            for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
                assert torch.equal(pa, pb), name


def test_two_parts_on_two_ranks_are_one_rank_bit_for_bit(tmp_path):
    imgs = _batches(6)
    np.savez(tmp_path / "part.npz", imgs=imgs)
    job = {"scenarios": ["part_parallel"], "glow": GLOW, "glow2": {}, "img2": IMG,
           "unet": UNET, "diff": DIFF}
    out = run_ranks(job, 2, tmp_path)
    # one rank holding both groups, in this process
    tdp, _ = _priors()
    cfg = tglow.GlowConfig(**GLOW)
    tcfg = tdt.DiffusionTrainConfig(lr_diffusion=1e-2, ema_decay=0.5, ema_update_every=1)
    plan = tpp.PartParallelPlan.build(0, TBackbone(cfg, IMG, frozen=True),
                                      tglow.init_glow(0, cfg, "cpu"), tdp, tcfg, device="cpu")
    assert [g.ranks for g in plan.groups] == [(0,), (0,)]
    for i, b in enumerate(imgs):
        loss = plan.step_group(i % 2, b, 7)
        rank = out[i % 2]["part_parallel"]  # group g lies on rank g
        assert float(rank[f"loss/{i}"]) == float(loss), i
    for prefer_ema in (False, True):
        want = _flat(convert.diffusion_to_jax_params(plan.joint_params(prefer_ema))["diffusion"])
        for r in range(2):
            got = {k[len(f"ema{int(prefer_ema)}/"):]: v
                   for k, v in out[r]["part_parallel"].items()
                   if k.startswith(f"ema{int(prefer_ema)}/")}
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_group_layouts():
    class M:  # a launch of 5 ranks, seen from rank 3, without collectives
        world, rank, group, device = 5, 3, None, torch.device("cpu")

    groups = tpp.part_group_meshes(2, M())
    assert [g.ranks for g in groups] == [(0, 1), (2, 3)]
    assert groups[0].mesh is None and groups[1].mesh.rank == 1 and groups[1].mesh.world == 2
    groups = tpp.part_group_meshes(3, type("One", (M,), {"world": 2, "rank": 1})())
    assert [g.ranks for g in groups] == [(0,), (1,), (0,)]
    assert [g.mesh is not None for g in groups] == [False, True, False]


@pytest.mark.parametrize("override", ["model.normalizing_flow.freeze=false", "parallel.fsdp=true",
                                      "load.load_batch=2"])
def test_refusals_of_the_jax_package(tmp_path, monkeypatch, override):
    monkeypatch.chdir(tmp_path)
    argv = ["device=cpu", "parallel.part_parallel=true", override]
    if override.startswith("load."):
        argv += ["load.load_exp_dir=somewhere", "load.load_epoch=1"]
    with pytest.raises(ValueError, match="part_parallel"):
        run_diffusion_prior.main(argv)
    tdp, _ = _priors()
    cfg = tglow.GlowConfig(**GLOW)
    with pytest.raises(ValueError, match="frozen flow"):
        tpp.make_part_train_step(TBackbone(cfg, IMG, frozen=False), tdp, 0,
                                 tdt.DiffusionTrainConfig(), None, device="cpu")


def test_train_part_parallel_resumes_bit_for_bit(tmp_path):
    import logging

    from nfdpm_tpu_torch.data import pipeline as tpipe
    from nfdpm_tpu_torch.training import checkpoint as tckpt

    tdp, _ = _priors()
    cfg = tglow.GlowConfig(**GLOW)
    flow = tglow.init_glow(0, cfg, "cpu")
    runs = {}
    for name, epochs, resume in (("full", 2, None), ("first", 1, None), ("resumed", 1, "first")):
        loaders = tpipe.read_dataset("synthetic", "", batch_size=BATCH, img_size=IMG, seed=0,
                                     synthetic_fallback=True, synthetic_n=3 * BATCH)
        tcfg = tdt.DiffusionTrainConfig(epochs=epochs, lr_diffusion=1e-2, ema_decay=0.5,
                                        ema_update_every=2, print_freq=2,
                                        save_checkpoint_freq=100)
        runs[name] = tpp.train_part_parallel(
            backbone=TBackbone(cfg, IMG, frozen=True), flow_params=flow, dp=tdp, tcfg=tcfg,
            loaders=loaders, run_dir=str(tmp_path / name), logger=logging.getLogger("pp"),
            seed=0, resume_dir=None if resume is None else str(tmp_path / resume),
            resume_epoch=None if resume is None else 1, device="cpu")
    assert runs["resumed"]["state"]["step"] == runs["full"]["state"]["step"] == 6
    for key in ("diffusion_parts", "diffusion"):
        full = dict(convert.named_leaves(tckpt._load(str(tmp_path / "full"), key, 2)))
        resumed = dict(convert.named_leaves(tckpt._load(str(tmp_path / "resumed"), key, 2)))
        assert full.keys() == resumed.keys()
        for k, v in full.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, resumed[k]), (key, k)
            else:
                assert v == resumed[k], (key, k)
