"""Rank scenarios of parameter partitioning over the data axis (fsdp), run by
tests/_torch_parallel_worker.py in tests/test_torch_fsdp_params.py's
launch of four gloo ranks at (data 2, model 2). Each records what the test
compares with the JAX package and with one process."""

import os

import numpy as np

from nfdpm_tpu_torch import convert
from nfdpm_tpu_torch.parallel import mesh as mesh_m
from nfdpm_tpu_torch.parallel import sharding_rules as rules
from nfdpm_tpu_torch.parallel import tensor_parallel as tp

from _torch_tp_scenarios import flat, glow_config


def _held_bytes(state, before, placements, index):
    """[held parameter bytes, predicted, held moment bytes, predicted]:
    `before` the parameters as the rank holds them before the data cut."""
    return np.asarray([rules.param_bytes(state["params"]),
                       rules.predicted_param_bytes(before, placements, index),
                       rules.moment_bytes(state["opt_state"]),
                       rules.predicted_moment_bytes(before, placements, index)])


def fsdp_steps(job, mesh, d):
    """Two stage-1 steps at the launch's (2, 2) mesh with fsdp, the JAX
    package's injected global noise: bits/dim, the whole parameters after
    each step, the bytes the rank holds between steps."""
    from nfdpm_tpu_torch.training import nf_trainer as tnft

    inputs = np.load(os.path.join(d, "fsdp.npz"))
    whole = convert.from_jax_params(convert.load_npz(os.path.join(d, "fsdp_tree.npz")), "cpu")
    cfg = glow_config(job, **job["fsdp_glow"])
    tcfg = tnft.NFTrainConfig(lr=1e-3)
    tx = tnft.optimizer_of(tcfg)
    params = convert.trainable(convert.from_jax_params(
        convert.load_npz(os.path.join(d, "fsdp_tree.npz")), "cpu"))
    state = tnft.shard_nf_state(mesh, tx, {"params": params, "opt_state": tx.init(params),
                                           "step": 0}, fsdp=True)
    placements = state["layout"].placements
    mine = tp.shard_tree(mesh.model, whole, rules.model_placements(mesh, whole))
    step = tnft.make_train_step(cfg, tcfg, tx, inject_noise=True, device="cpu", mesh=mesh)
    out = {"bytes": _held_bytes(state, mine, placements, mesh.data_rank),
           "placed": np.asarray(len(placements))}
    bpds = []
    for i in range(len(inputs["imgs"])):
        state, m = step(state, mesh_m.shard_batch(mesh, inputs["imgs"][i]), inputs["noise"][i])
        bpds.append(float(m["bpd"]))
        out.update(flat(convert.to_jax_params(tnft.whole_nf_state(mesh, state)["params"]),
                        f"step{i + 1}"))
    out["bpd"] = np.asarray(bpds)
    out["bytes_after"] = _held_bytes(state, mine, placements, mesh.data_rank)
    return out


def fsdp_data4(job, mesh, d):
    """On a (4, 1) mesh of the same ranks: the bytes of CFG_FSDP's state
    with and without fsdp; two steps of a flow whose small leaves are placed
    whole on owners (FSDP_MIN_SIZE 16, K = 4 steps of 4 channels); one
    stage-2 step with the frozen flow, the UNet and the EMA shadow
    partitioned."""
    from nfdpm_tpu_torch.training import nf_trainer as tnft

    data4 = mesh_m.make_mesh(n_model=1, device="cpu")
    out = {}
    # memory: the replicated layout and the partitioned one
    tcfg = tnft.NFTrainConfig(lr=1e-3)
    tx = tnft.optimizer_of(tcfg)
    for fsdp in (False, True):
        params = convert.trainable(convert.from_jax_params(
            convert.load_npz(os.path.join(d, "fsdp_tree.npz")), "cpu"))
        state = tnft.shard_nf_state(data4, tx, {"params": params,
                                                "opt_state": tx.init(params), "step": 0}, fsdp)
        placements = state["layout"].placements if "layout" in state else {}
        out[f"memory/fsdp{int(fsdp)}"] = _held_bytes(state, params, placements,
                                                     data4.data_rank)
    # owners
    saved = rules.FSDP_MIN_SIZE
    rules.FSDP_MIN_SIZE = 16
    try:
        inputs = np.load(os.path.join(d, "owner.npz"))
        cfg = glow_config(job, **job["owner_glow"])
        params = convert.trainable(convert.from_jax_params(
            convert.load_npz(os.path.join(d, "owner_tree.npz")), "cpu"))
        state = tnft.shard_nf_state(data4, tx, {"params": params,
                                                "opt_state": tx.init(params), "step": 0}, True)
        owners = {p: pl.owner for p, pl in state["layout"].placements.items()
                  if pl.dim is None}
        out["owner/placed_whole"] = np.asarray(len(owners))
        out["owner/held_whole"] = np.asarray(sum(
            1 for p, t in convert.named_leaves(state["params"])
            if p in owners and t.numel() and owners[p] == data4.data_rank))
        step = tnft.make_train_step(cfg, tcfg, tx, inject_noise=True, device="cpu", mesh=data4)
        bpds = []
        for i in range(len(inputs["imgs"])):
            state, m = step(state, mesh_m.shard_batch(data4, inputs["imgs"][i]),
                            inputs["noise"][i])
            bpds.append(float(m["bpd"]))
        out["owner/bpd"] = np.asarray(bpds)
        out.update(flat(convert.to_jax_params(tnft.whole_nf_state(data4, state)["params"]),
                        "owner/params"))
    finally:
        rules.FSDP_MIN_SIZE = saved
    out.update(_stage2_step(job, data4, d))
    return out


def _stage2_step(job, mesh, d):
    from nfdpm_tpu_torch.models import formaters as tfmt
    from nfdpm_tpu_torch.models.diffusion_prior import DiffusionPrior
    from nfdpm_tpu_torch.models.nf_backbone import NFBackbone
    from nfdpm_tpu_torch.training import diffusion_trainer as tdt

    conf = job["fsdp_stage2"]
    inputs = np.load(os.path.join(d, "fsdp2.npz"))
    tree = convert.load_npz(os.path.join(d, "fsdp2_tree.npz"))
    formater = tfmt.IdentityFormater(L=2, in_channels=3, size=conf["img"])
    dp = DiffusionPrior(formater, dict(conf["unet"]), dict(conf["diff"]))
    tcfg = tdt.DiffusionTrainConfig(lr_diffusion=1e-3, ema_decay=0.9, ema_update_every=1)
    tx = tdt.make_two_group_optimizer(tcfg, True)
    bb = NFBackbone(glow_config(job, **conf["glow"]), conf["img"], frozen=True)
    params = convert.diffusion_from_jax_params(tree, dp, "cpu", requires_grad=True)
    params.pop("prior")
    whole = {"flow": params["flow"], "diffusion": {
        "parts": dp.unets_from_named(convert.map_tree(params["diffusion"], lambda t: t)["parts"],
                                     "cpu")}}
    state = {"params": params, "opt_state": tx.init(params), "step": 0,
             "ema": tdt._ema_copy(params, True)}
    state = tdt.shard_diffusion_state(mesh, tx, state, True)
    placements = state["layout"].placements
    out = {"stage2/bytes": _held_bytes(state, whole, placements, mesh.data_rank),
           "stage2/ema_bytes": np.asarray([
               rules.param_bytes(state["ema"]),
               rules.predicted_param_bytes({"diffusion": whole["diffusion"]}, placements,
                                           mesh.data_rank)]),
           "stage2/flow_placed": np.asarray(sum(p.startswith("flow/") for p in placements)),
           "stage2/unet_placed": np.asarray(sum(p.startswith("diffusion/") for p in placements))}
    step = tdt.make_train_step(bb, dp, tcfg, tx, inject_noise=True, device="cpu", mesh=mesh)
    draws = {"dequant": inputs["dequant"],
             "parts": [{"t": inputs[f"t_{j}"], "noise": inputs[f"noise_{j}"],
                        "self_cond": bool(inputs[f"coin_{j}"])} for j in range(dp.num_parts)]}
    state, m = step(state, mesh_m.shard_batch(mesh, inputs["imgs"]), draws)
    out["stage2/loss"] = np.asarray(float(m["loss"]))
    whole_state = tdt.whole_diffusion_state(mesh, state)
    out.update(flat(convert.diffusion_to_jax_params(whole_state["params"])["diffusion"],
                    "stage2/params"))
    out.update(flat(convert.map_tree(whole_state["ema"], lambda t: t), "stage2/ema"))
    return out


SCENARIOS = {"fsdp_steps": fsdp_steps, "fsdp_data4": fsdp_data4}
