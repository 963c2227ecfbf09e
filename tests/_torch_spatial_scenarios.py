"""Spatial partitioning's and split GroupNorm's scenarios for
tests/_torch_parallel_worker.py.

Each runs on one rank of a ("data", "model") mesh (the job's "n_model"),
on the CPU over gloo, and returns {name: array}; the worker writes it to
<dir>/<scenario>_r<rank>.npz. What a rank holds as its rows or its slab is
gathered whole before it is written, so that the tests hold it against one
device's value or the JAX package's. Imports the port only (no JAX).
"""

import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from nfdpm_tpu_torch import convert
from nfdpm_tpu_torch.parallel import mesh as mesh_m
from nfdpm_tpu_torch.parallel import sharding_rules as rules
from nfdpm_tpu_torch.parallel import spatial as sp
from nfdpm_tpu_torch.parallel import tensor_parallel as tp
from nfdpm_tpu_torch.ops import zeroconv


def flat(tree, prefix):
    """{path: a copy}: a CPU tensor's numpy view would follow later steps."""
    out = {}
    convert._flatten(tree, prefix, out)
    return {k: np.array(v) for k, v in out.items()}


def glow_config(job, **kw):
    from nfdpm_tpu_torch.models import glow as tglow

    return tglow.GlowConfig(**{**job["glow"], **kw})


def leaf_grads(tree, prefix):
    """{prefix/path: a copy of the leaf's .grad} for every leaf that has one."""
    return {f"{prefix}/{path}": p.grad.detach().numpy().copy()
            for path, p in convert.named_leaves(tree) if p.grad is not None}


def row_conv(job, mesh, d):
    """conv2d_nhwc_rows of a rank's rows over a model axis of the job's
    "conv_n_model" (2 or 4 rows a shard and 1), 3x3, SAME: the output and
    the input's gradient gathered whole, the weight's gradient summed over
    the model group."""
    if job.get("conv_n_model", mesh.n_model) != mesh.n_model:
        mesh = mesh_m.make_mesh(n_model=job["conv_n_model"], device="cpu")
    axis = mesh.model
    data = np.load(os.path.join(d, "conv.npz"))
    out = {}
    for rows in (2, 1):
        x = torch.from_numpy(data[f"x{rows}"])
        g = torch.from_numpy(data[f"g{rows}"])
        w = torch.from_numpy(data["w"]).requires_grad_(True)
        xr = sp.cut_rows(axis, x).requires_grad_(True)
        y = zeroconv.conv2d_nhwc_rows(xr, w, axis)
        (y * sp.cut_rows(axis, g)).sum().backward()
        dw = w.grad.clone()
        dist.all_reduce(dw, group=axis.group)
        out[f"{rows}/y"] = sp.gather_rows(axis, y.detach()).numpy()
        out[f"{rows}/dx"] = sp.gather_rows(axis, xr.grad).numpy()
        out[f"{rows}/dw"] = dw.numpy()
    return out


def _stage1_state(tree, cfg, tcfg, mesh, fsdp=False):
    from nfdpm_tpu_torch.training import nf_trainer as tnft

    tx = tnft.optimizer_of(tcfg)
    params = convert.trainable(convert.from_jax_params(tree, "cpu"))
    state = {"params": params, "opt_state": tx.init(params), "step": 0}
    return tx, tnft.shard_nf_state(mesh, tx, state, fsdp)


def sp_stage1(job, mesh, d):
    """Stage-1 steps at the spatial mesh with the injected global noise:
    bits/dim of each step and step 1's gradients (the model group's sum,
    the data ranks' mean) from the JAX layout's tree, and each variant of
    the job's (fsdp, grad_accum, remat, bf16) for two steps: bits/dim and
    the whole parameters after."""
    from nfdpm_tpu_torch.training import nf_trainer as tnft

    inputs = np.load(os.path.join(d, "stage1.npz"))
    tree = convert.load_npz(os.path.join(d, "stage1_tree.npz"))
    smesh = mesh_m.checked_spatial(mesh, inputs["imgs"].shape[2], job["glow"]["levels"])
    out = {}
    for variant in job["stage1_variants"]:
        name, steps = variant["name"], variant["steps"]
        cfg = glow_config(job, **variant.get("glow", {}))
        tcfg = tnft.NFTrainConfig(lr=1e-3, **variant.get("tcfg", {}))
        tx, state = _stage1_state(tree, cfg, tcfg, smesh, variant.get("fsdp", False))
        seeded = variant.get("seed") is not None
        step = tnft.make_train_step(cfg, tcfg, tx, inject_noise=not seeded, device="cpu",
                                    mesh=smesh)
        bpds = []
        for i in range(steps):
            rows = mesh_m.shard_batch(smesh, inputs["imgs"][i], tcfg.grad_accum)
            state, m = step(state, rows, variant["seed"] if seeded else inputs["noise"][i])
            bpds.append(float(m["bpd"]))
            if i == 0 and variant.get("grads"):
                out.update(leaf_grads(state["params"], f"{name}/grad"))
        out[f"{name}/bpd"] = np.asarray(bpds)
        out.update(flat(convert.to_jax_params(tnft.whole_nf_state(smesh, state)["params"]),
                        f"{name}/params"))
        held = rules.param_bytes({"flow": state["params"]["flow"]})
        out[f"{name}/flow_bytes"] = np.asarray(held)
    return out


def _diffusion_prior(job, formater_name):
    from nfdpm_tpu_torch.models import formaters as tfmt
    from nfdpm_tpu_torch.models.diffusion_prior import DiffusionPrior

    f = tfmt.get_formater(formater_name)(L=job["glow"]["levels"], in_channels=3,
                                         size=job["img2"])
    return DiffusionPrior(f, dict(job["unet"]), dict(job["diff"]))


def _whole_diffusion_params(mesh, state, dp):
    from nfdpm_tpu_torch.training import diffusion_trainer as tdt

    whole = tdt.whole_diffusion_state(mesh, state)["params"]
    parts = whole["diffusion"]["parts"]
    if isinstance(parts[0], dict):  # slabs gathered: parameters by name
        parts = dp.unets_from_named(parts, "cpu")
    tree = convert.diffusion_to_jax_params({"flow": whole["flow"],
                                            "diffusion": {"parts": parts}})
    tree.pop("prior", None)
    return tree


def _stage2_steps(job, mesh, d, with_grads=False):
    """The job's stage-2 configurations' steps on `mesh` with the JAX
    package's draws injected: the losses, the whole parameters after and,
    `with_grads`, step 1's gradients (the UNets' slabs gathered whole)."""
    from nfdpm_tpu_torch.models.nf_backbone import NFBackbone
    from nfdpm_tpu_torch.training import diffusion_trainer as tdt

    out = {}
    for conf in job["stage2"]:
        name = conf["name"]
        inputs = np.load(os.path.join(d, f"stage2_{name}.npz"))
        tree = convert.load_npz(os.path.join(d, f"stage2_{name}_tree.npz"))
        dp = _diffusion_prior(job, conf["formater"])
        frozen = conf["frozen"]
        tcfg = tdt.DiffusionTrainConfig(**conf["tcfg"])
        tx = tdt.make_two_group_optimizer(tcfg, frozen)
        bb = NFBackbone(glow_config(job, **job["glow2"]), job["img2"], frozen=frozen)
        params = convert.diffusion_from_jax_params(tree, dp, "cpu", requires_grad=True)
        params.pop("prior")
        state = tdt.shard_diffusion_state(mesh, tx, {"params": params,
                                                     "opt_state": tx.init(params), "step": 0})
        step = tdt.make_train_step(bb, dp, tcfg, tx, inject_noise=True, device="cpu", mesh=mesh)
        losses = []
        for i in range(len(inputs["imgs"])):
            draws = {"dequant": inputs[f"dequant_{i}"],
                     "parts": [{"t": inputs[f"t_{i}_{j}"], "noise": inputs[f"noise_{i}_{j}"],
                                "self_cond": bool(inputs[f"coin_{i}_{j}"])}
                               for j in range(dp.num_parts)]}
            state, m = step(state, mesh_m.shard_batch(mesh, inputs["imgs"][i]), draws)
            losses.append(float(m["loss"]))
            if i == 0 and with_grads:
                p = state["params"]
                grads = {"flow": convert.map_tree(p["flow"], lambda t: t.grad),
                         "diffusion": {"parts": [{n: q.grad for n, q in u.named_parameters()}
                                                 for u in p["diffusion"]["parts"]]}}
                grads = tp.gather_leaves(mesh.model, grads, rules.model_placements(mesh, p))
                out.update({f"{name}/grad/{k}": v.numpy().copy()
                            for k, v in convert.named_leaves(grads) if v is not None})
        out[f"{name}/loss"] = np.asarray(losses)
        out.update(flat(_whole_diffusion_params(mesh, state, dp), f"{name}/params"))
    return out


def sp_stage2(job, mesh, d):
    """Stage-2 steps at the spatial mesh, frozen and co-trained, with the
    JAX package's draws injected: the losses, step 1's gradients (the
    UNets' slabs gathered whole, the co-trained flow's summed over the model
    group) and the whole parameters after."""
    smesh = mesh_m.checked_spatial(mesh, job["img2"], job["glow"]["levels"])
    return _stage2_steps(job, smesh, d, with_grads=True)


def _saved_bytes(fn):
    """The bytes of the distinct storages autograd saves while `fn` runs
    (what a backward would read), the parameters' own storages left out."""
    seen = {}

    def pack(t):
        storage = t.untyped_storage()
        seen[storage.data_ptr()] = storage.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return seen


def sp_memory(job, mesh, d):
    """Bytes autograd saves in a stage-1 loss at L2/K2/w64, 32x32, batch 8:
    the whole images of the rank's data block (the data-only step) and its
    row block on the spatial mesh."""
    from nfdpm_tpu_torch.models import glow as tglow
    from nfdpm_tpu_torch.training import nf_trainer as tnft

    cfg = tglow.GlowConfig(**job["memory_glow"])
    tcfg = tnft.NFTrainConfig()
    tx = tnft.optimizer_of(tcfg)
    state = tnft.init_train_state(0, cfg, tcfg, tx, "cpu")
    params = state["params"]
    skip = {p.untyped_storage().data_ptr() for _, p in convert.named_leaves(params)}
    imgs = torch.from_numpy(np.load(os.path.join(d, "memory.npz"))["imgs"])
    noise = torch.from_numpy(np.load(os.path.join(d, "memory.npz"))["noise"])
    smesh = mesh_m.checked_spatial(mesh, imgs.shape[1], cfg.levels)
    out = {}
    for name, loss in (("data_only", tnft.make_loss_fn(cfg, tcfg)),
                       ("spatial", tnft.make_loss_fn(cfg, tcfg, rows=mesh_m.rows_of(smesh)))):
        seen = _saved_bytes(lambda: loss(params, imgs, noise=noise)[0].backward())
        out[f"{name}/bytes"] = np.asarray(sum(n for ptr, n in seen.items() if ptr not in skip))
    return out


def sp_checkpoint(job, mesh, d):
    """A spatial stage-1 run of one epoch through nf_trainer.train (ddinit,
    the steps, the checkpoint, the final bits/dim of the whole flow)."""
    from nfdpm_tpu_torch.data import pipeline as tpipe
    from nfdpm_tpu_torch.training import nf_trainer as tnft

    os.environ["NFDPM_NO_TENSORBOARD"] = "1"
    c = job["checkpoint"]
    tcfg = tnft.NFTrainConfig(epochs=1, lr=1e-3, print_freq=100, save_checkpoint_freq=100)
    loaders = tpipe.read_dataset("synthetic", "", batch_size=c["batch"], img_size=c["img"],
                                 seed=0, synthetic_fallback=True, synthetic_n=c["n"])
    cfg, logger = glow_config(job, **c["glow"]), logging.getLogger("sp")
    smesh = mesh_m.spatial_for_training(mesh, c["img"], cfg.levels, logger)
    res = tnft.train(cfg=cfg, tcfg=tcfg, loaders=loaders,
                     run_dir=os.path.join(d, "spatial_run"), logger=logger,
                     seed=0, img_size=c["img"], device="cpu", mesh=smesh)
    out = flat(convert.to_jax_params(tnft.whole_nf_state(smesh, res["state"])["params"]),
               "params")
    out["bpd"] = np.asarray([res["results"]["bpd_test"], res["results"]["bpd_train"]])
    return out


def _sub_axis(ranks):
    """The model axis of `ranks` (a process group every rank makes), None
    on a rank outside them."""
    group = dist.new_group(ranks)
    me = dist.get_rank()
    if me not in ranks:
        return None
    return tp.ModelAxis(n=len(ranks), index=ranks.index(me), group=group, rank=me,
                        world=dist.get_world_size())


def split_groupnorm(job, mesh, d):
    """The UNet's GroupNorm on a rank's channel slab at each (G, n) of the
    job: the output and the input's, weight's and bias's gradients, each
    rank's slab gathered whole."""
    from nfdpm_tpu_torch.models.unet import GroupNorm

    data = np.load(os.path.join(d, "groupnorm.npz"))
    out = {}
    for groups, n in job["groupnorm"]:
        axis = _sub_axis(list(range(n)))
        if axis is None:
            continue
        key = f"{groups}_{n}"
        c = data[f"{key}/x"].shape[1]
        norm = GroupNorm(groups, c, eps=1e-5)
        norm.weight = torch.nn.Parameter(axis.slab(torch.from_numpy(data[f"{key}/w"]), 0).clone())
        norm.bias = torch.nn.Parameter(axis.slab(torch.from_numpy(data[f"{key}/b"]), 0).clone())
        norm.axis = axis
        x = axis.slab(torch.from_numpy(data[f"{key}/x"]), 1).clone().requires_grad_(True)
        y = norm(x)
        (y * axis.slab(torch.from_numpy(data[f"{key}/g"]), 1)).sum().backward()
        for what, t in (("y", y.detach()), ("dx", x.grad), ("dw", norm.weight.grad),
                        ("db", norm.bias.grad)):
            out[f"{key}/{what}"] = tp.all_gather_dim(axis, t, 1 if t.dim() == 4 else 0).numpy()
    return out


def split_unet(job, mesh, d):
    """At (data 1, model 2) on ranks 0 and 1: a UNet of the job's group count
    on the model axis's slabs, its output on a batch, and the job's stage-2
    steps (losses, whole parameters)."""
    from nfdpm_tpu_torch.models.unet import Unet, shard_unet_

    mesh = mesh_m.mesh_over([0, 1], n_model=2, device="cpu", group=dist.new_group([0, 1]))
    if mesh is None:
        return {}
    data = np.load(os.path.join(d, "unet.npz"))
    unet = convert.unet_from_flax(Unet(channels=3, **job["unet"]),
                                  convert.load_npz(os.path.join(d, "unet_tree.npz")))
    unet = shard_unet_(unet, mesh.model)
    with torch.no_grad():
        o = unet(torch.from_numpy(data["x"]), torch.from_numpy(data["t"]), use_kernels=True)
    return {"unet/out": o.numpy(), **_stage2_steps(job, mesh, d)}


SCENARIOS = {"row_conv": row_conv, "sp_stage1": sp_stage1, "sp_stage2": sp_stage2,
             "sp_memory": sp_memory, "sp_checkpoint": sp_checkpoint,
             "split_groupnorm": split_groupnorm, "split_unet": split_unet}
