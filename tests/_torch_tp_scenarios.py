"""The model axis's scenarios for tests/_torch_parallel_worker.py.

Each runs on one rank of a ("data", "model") mesh (the job's "n_model"),
on the CPU over gloo, and returns {name: array}; the worker writes it to
<dir>/<scenario>_r<rank>.npz. Whatever is a rank's slab is gathered whole
before it is written, so that the tests hold it against one device's value
or the JAX package's. Imports the port only (no JAX).
"""

import logging
import os

import numpy as np
import torch

from nfdpm_tpu_torch import convert
from nfdpm_tpu_torch.parallel import mesh as mesh_m
from nfdpm_tpu_torch.parallel import sharding_rules as rules
from nfdpm_tpu_torch.parallel import tensor_parallel as tp


def flat(tree, prefix):
    """{path: a copy}: a CPU tensor's numpy view would follow later steps."""
    out = {}
    convert._flatten(tree, prefix, out)
    return {k: np.array(v) for k, v in out.items()}


def glow_config(job, **kw):
    from nfdpm_tpu_torch.models import glow as tglow

    return tglow.GlowConfig(**{**job["glow"], **kw})


def coords(job, mesh, d):
    """This rank's place on the mesh and its groups' members (global ranks),
    at the launch's n_slices and, when the job names it, at another."""
    import torch.distributed as dist

    out = {}
    meshes = [("mesh", mesh)]
    if job.get("also_slices"):
        meshes.append(("slices", mesh_m.make_mesh(n_model=mesh.n_model,
                                                  n_slices=job["also_slices"], device="cpu")))
    for name, m in meshes:
        out[f"{name}/coords"] = np.asarray([m.data_rank, m.model_rank, m.n_data, m.n_model])
        out[f"{name}/model_group"] = np.asarray(dist.get_process_group_ranks(m.model_group))
        if m.data_group is not None:
            out[f"{name}/data_group"] = np.asarray(dist.get_process_group_ranks(m.data_group))
    return out


def _net_placements(net, n_model):
    """Model placements of a bare coupling net, by its own paths."""
    flow = {"blocks": [], "final_steps": [{"coupling": {"net": net}}]}
    pre = "flow/final_steps/0/coupling/net/"
    return {k[len(pre):]: v for k, v in rules.glow_model_placements(flow, n_model).items()}


def layers(job, mesh, d):
    """The coupling net and the UNet on the rank's slabs: outputs, inverse,
    gradients (gathered whole), bf16, the data-dependent init, a small
    Glow's forward, inverse and ddinit on both step routes."""
    from nfdpm_tpu_torch.models import glow as tglow
    from nfdpm_tpu_torch.models.unet import Unet, shard_unet_
    from nfdpm_tpu_torch.ops import bijectors as bj
    from nfdpm_tpu_torch.ops import coupling

    axis = mesh.model
    data = np.load(os.path.join(d, "layers.npz"))
    out = {}
    # the coupling net, from the JAX layout (HWIO)
    net = {k: {kk: torch.from_numpy(np.ascontiguousarray(
               convert._hwio_to_oihw(data[f"net/{k}/{kk}"]) if kk == "w" and
               data[f"net/{k}/{kk}"].ndim == 4 else data[f"net/{k}/{kk}"]))
               for kk in ("w", "b", "logs", "scale", "bias") if f"net/{k}/{kk}" in data}
           for k in ("conv1", "an1", "conv2", "an2", "zconv")}
    placements = _net_placements(net, mesh.n_model)
    mine = tp.shard_tree(axis, net, placements)
    mine = {k: {kk: v.detach().requires_grad_(True) for kk, v in sub.items()}
            for k, sub in mine.items()}
    x = torch.from_numpy(data["x"]).requires_grad_(True)
    ldj = torch.zeros(x.shape[0])
    y, ldj = bj.coupling_forward({"net": mine}, x, ldj, model=axis)
    (y * torch.from_numpy(data["weights"])).sum().add(ldj.sum()).backward()
    out["coupling/y"], out["coupling/ldj"] = y.detach().numpy(), ldj.detach().numpy()
    out["coupling/dx"] = x.grad.numpy()
    grads = {k: {kk: v.grad for kk, v in sub.items()} for k, sub in mine.items()}
    out.update(flat(tp.gather_leaves(axis, grads, placements), "coupling/grad"))
    with torch.no_grad():
        out["coupling/inverse"] = bj.coupling_inverse({"net": mine}, y, model=axis).numpy()
        xa = x.detach()[..., :x.shape[-1] // 2]
        out["coupling/r"] = coupling.coupling_net_conv(mine, xa, model=axis).numpy()
        out["coupling/bf16"] = coupling.coupling_net_apply(mine, xa, torch.bfloat16,
                                                           axis).numpy()
        new, ddout = coupling.coupling_net_ddinit(mine, xa, axis)
        out["coupling/ddinit_out"] = ddout.numpy()
        out.update(flat(tp.gather_leaves(axis, {k: new[k] for k in ("an1", "an2")}, placements),
                        "coupling/ddinit"))
    # a small Glow on both step routes
    tree = convert.load_npz(os.path.join(d, "glow_tree.npz"))
    glow_x = torch.from_numpy(data["glow_x"])
    for use_kernels in (False, True):
        cfg = glow_config(job, use_kernels=use_kernels)
        whole = convert.from_jax_params(tree, "cpu")
        params = convert.params_for_rank(whole, mesh)
        tag = f"glow_k{int(use_kernels)}"
        with torch.no_grad():
            latents, ldj, logp = tglow.forward(params["flow"], cfg, glow_x, model=axis)
            out[f"{tag}/ldj"], out[f"{tag}/logp"] = ldj.numpy(), logp.numpy()
            out[f"{tag}/inverse"] = tglow.inverse(params["flow"], cfg, latents,
                                                  model=axis).numpy()
            for i, z in enumerate(latents):
                out[f"{tag}/z{i}"] = z.numpy()
        new = tglow.ddinit(params["flow"], cfg, glow_x, model=axis)
        flow_pl = rules.glow_model_placements(new, mesh.n_model, "flow")
        out.update(flat(convert.to_jax_params(
            tp.gather_leaves(axis, {"flow": new, "prior": None}, flow_pl)), f"{tag}/ddinit"))
    # the UNet, from the flax tree
    unet = convert.unet_from_flax(Unet(channels=3, **job["unet_tp"]),
                                  convert.load_npz(os.path.join(d, "unet_tree.npz")))
    unet = shard_unet_(unet.requires_grad_(True), axis)
    xu = torch.from_numpy(data["unet_x"])
    o = unet(xu, torch.from_numpy(data["unet_t"]), use_kernels=True)
    loss = ((o - torch.from_numpy(data["unet_target"])) ** 2).mean()
    loss.backward()
    out["unet/out"], out["unet/loss"] = o.detach().numpy(), loss.detach().numpy()
    unet_pl = rules.unet_model_placements(unet, mesh.n_model)
    grads = {n: p.grad for n, p in unet.named_parameters()}
    out.update(flat(tp.gather_leaves(axis, grads, unet_pl), "unet/grad"))
    return out


def _stage1_state(job, d, tcfg, mesh, fsdp):
    from nfdpm_tpu_torch.training import nf_trainer as tnft

    tree = convert.load_npz(os.path.join(d, "stage1_tree.npz"))
    tx = tnft.optimizer_of(tcfg)
    params = convert.trainable(convert.from_jax_params(tree, "cpu"))
    state = tnft.shard_nf_state(mesh, tx, {"params": params, "opt_state": tx.init(params),
                                           "step": 0}, fsdp)
    return tx, state


def steps(job, mesh, d):
    """Stage-1 steps with the injected global noise (fsdp off and on) and
    the step's own generator, stage-2 steps (frozen and co-trained) with
    injected draws: metrics and whole parameters; the rank's own leaves,
    their shapes and bytes against the placements."""
    from nfdpm_tpu_torch.training import nf_trainer as tnft

    inputs = np.load(os.path.join(d, "stage1.npz"))
    cfg = glow_config(job)
    out = {}
    for fsdp, mode in job["stage1_modes"]:
        tcfg = tnft.NFTrainConfig(lr=1e-3)
        tx, state = _stage1_state(job, d, tcfg, mesh, fsdp)
        step = tnft.make_train_step(cfg, tcfg, tx, inject_noise=mode == "noise", device="cpu",
                                    mesh=mesh)
        placements = state["layout"].placements if "layout" in state else {}
        tag = f"{mode}_fsdp{int(fsdp)}"
        bpds = []
        for i in range(len(inputs["imgs"])):
            rows = mesh_m.shard_batch(mesh, inputs["imgs"][i])
            state, m = step(state, rows, inputs["noise"][i] if mode == "noise" else 5)
            bpds.append(float(m["bpd"]))
            if i == 0:
                whole = tnft.whole_nf_state(mesh, state)
                out.update(flat(convert.to_jax_params(whole["params"]), f"{tag}/step1"))
        out[f"{tag}/bpd"] = np.asarray(bpds)
        whole = tnft.whole_nf_state(mesh, state)
        out.update(flat(convert.to_jax_params(whole["params"]), f"{tag}/step3"))
        # what this rank holds: its leaves as they are, their bytes
        out.update(flat(state["params"], f"{tag}/held"))
        # the rank's model slabs before the data cut (whole leaves without a
        # model axis): what the data placements cut
        whole_params = convert.from_jax_params(convert.load_npz(
            os.path.join(d, "stage1_tree.npz")), "cpu")
        model_pl = rules.model_placements(mesh, whole_params)
        mine = tp.shard_tree(mesh.model, whole_params, model_pl)
        params_by_path = dict(convert.named_leaves(mine))
        for path, t in convert.named_leaves(state["opt_state"]["mu"]):
            want = params_by_path[path].shape
            if path in placements:
                want = placements[path].slab(params_by_path[path], mesh.data_rank).shape
            out[f"{tag}/moment_shape/{path}"] = np.asarray([list(t.shape), list(want)])
        out[f"{tag}/bytes"] = np.asarray([
            rules.param_bytes(state["params"]),
            rules.predicted_param_bytes(mine, placements, mesh.data_rank),
            rules.moment_bytes(state["opt_state"]),
            rules.predicted_moment_bytes(mine, placements, mesh.data_rank)])
    if job.get("stage2"):
        out.update(_stage2_steps(job, mesh, d))
    return out


def _diffusion_prior(job, formater):
    from nfdpm_tpu_torch.models import formaters as tfmt
    from nfdpm_tpu_torch.models.diffusion_prior import DiffusionPrior

    f = tfmt.get_formater(formater)(L=2, in_channels=3, size=job["img2"])
    return DiffusionPrior(f, dict(job["unet"]), dict(job["diff"]))


def _whole_diffusion_params(mesh, state, dp):
    from nfdpm_tpu_torch.training import diffusion_trainer as tdt

    whole = tdt.whole_diffusion_state(mesh, state)["params"]
    params = {"flow": whole["flow"],
              "diffusion": {"parts": dp.unets_from_named(whole["diffusion"]["parts"], "cpu")}}
    tree = convert.diffusion_to_jax_params(params)
    tree.pop("prior", None)
    return tree


def _stage2_steps(job, mesh, d):
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
        state = {"params": params, "opt_state": tx.init(params), "step": 0}
        if tcfg.ema_decay is not None:
            state["ema"] = tdt._ema_copy(params, frozen)
        state = tdt.shard_diffusion_state(mesh, tx, state, False)
        step = tdt.make_train_step(bb, dp, tcfg, tx, inject_noise=True, device="cpu", mesh=mesh)
        losses = []
        for i in range(len(inputs["imgs"])):
            draws = {"dequant": inputs[f"dequant_{i}"],
                     "parts": [{"t": inputs[f"t_{i}_{j}"], "noise": inputs[f"noise_{i}_{j}"],
                                "self_cond": bool(inputs[f"coin_{i}_{j}"])}
                               for j in range(dp.num_parts)]}
            state, m = step(state, mesh_m.shard_batch(mesh, inputs["imgs"][i]), draws)
            losses.append(float(m["loss"]))
        out[f"{name}/loss"] = np.asarray(losses)
        out.update(flat(_whole_diffusion_params(mesh, state, dp), f"{name}/params"))
        out.update(flat(convert.map_tree(state["params"], lambda t: t), f"{name}/held"))
        if "ema" in state:
            ema = tp.gather_leaves(mesh.model, state["ema"],
                                   rules.model_placements(mesh, state["params"]))
            out.update(flat(convert.map_tree(ema, lambda t: t), f"{name}/ema"))
    return out


def evaluation(job, mesh, d):
    """Scoring and sampling on the rank's slabs: bits/dim (one draw and
    IWAE), the Glow sampler, the VLB, DDIM and DDPM chunks."""
    from nfdpm_tpu_torch import inference
    from nfdpm_tpu_torch.data import pipeline as tpipe
    from nfdpm_tpu_torch.models.nf_backbone import NFBackbone
    from nfdpm_tpu_torch.training import diffusion_trainer as tdt
    from nfdpm_tpu_torch.training import nf_trainer as tnft

    out = {}
    cfg = glow_config(job)
    tcfg = tnft.NFTrainConfig()
    params = convert.params_for_rank(convert.from_jax_params(convert.load_npz(
        os.path.join(d, "stage1_tree.npz")), "cpu"), mesh)
    loader = tpipe.read_dataset("synthetic", "", batch_size=8, img_size=8, seed=0,
                                synthetic_fallback=True, synthetic_n=24).test
    eval_step = tnft.make_eval_step(cfg, tcfg, "cpu", mesh.model)
    for k, iwae in ((1, False), (2, True)):
        out[f"bpd_k{k}"] = np.asarray(tnft.calculate_bpd(eval_step, params, loader, 3, k, iwae,
                                                         mesh))
    out["glow_samples"] = tnft.make_sample_fn(cfg, tcfg, 8, 3, "cpu", mesh)(
        params, 5, 0.8, 2).numpy()
    tree2 = convert.load_npz(os.path.join(d, "stage2_frozen_tree.npz"))
    bb = NFBackbone(glow_config(job, **job["glow2"]), job["img2"], frozen=True)
    loader2 = tpipe.read_dataset("synthetic", "", batch_size=4, img_size=job["img2"], seed=0,
                                 synthetic_fallback=True, synthetic_n=8).test
    for sampler, sampling_timesteps in (("ddim", 4), ("ddpm", 8)):
        job_s = dict(job, diff=dict(job["diff"], sampling_timesteps=sampling_timesteps))
        dp = _diffusion_prior(job_s, "IdentityFormater")
        p2 = convert.diffusion_from_jax_params(tree2, dp, "cpu")
        p2.pop("prior")
        p2 = convert.params_for_rank(p2, mesh)
        sample = inference.make_diffusion_sample_fn(tdt.on_mesh(mesh, bb), dp, 5, "cpu")
        images, latents = sample(p2, 3, generator=inference.reseed(torch.Generator(), 4, 1),
                                 return_latents=True)
        out[f"{sampler}/images"] = images.numpy()
        for i, z in enumerate(latents):
            out[f"{sampler}/z{i}"] = z.numpy()
        if sampler == "ddim":
            out["vlb"] = np.asarray(tdt.calculate_bpd_with_diff_prior(
                bb, dp, tdt.DiffusionTrainConfig(), p2, loader2, 3, max_batches=1,
                device="cpu", mesh=mesh))
    return out


def checkpoints(job, mesh, d):
    """A checkpoint written at one rank resumed here for an epoch, and a
    first epoch trained here (its checkpoint resumed at one rank by the
    test), with the job's "fsdp" and "pipeline_microbatches"."""
    from nfdpm_tpu_torch.data import pipeline as tpipe
    from nfdpm_tpu_torch.training import nf_trainer as tnft

    os.environ["NFDPM_NO_TENSORBOARD"] = "1"
    cfg = glow_config(job)
    tcfg = tnft.NFTrainConfig(epochs=1, lr=1e-3, print_freq=100, save_checkpoint_freq=100)
    out = {}
    for name, kwargs in (("from_world1", dict(resume_dir=os.path.join(d, "world1_run"),
                                              resume_epoch=1)),
                         ("first_epoch", {})):
        loaders = tpipe.read_dataset("synthetic", "", batch_size=8, img_size=8, seed=0,
                                     synthetic_fallback=True, synthetic_n=32)
        res = tnft.train(cfg=cfg, tcfg=tcfg, loaders=loaders, run_dir=os.path.join(d, name),
                         logger=logging.getLogger("tp"), seed=0, img_size=8, device="cpu",
                         mesh=mesh, fsdp=job.get("fsdp", False),
                         pipeline_microbatches=job.get("pipeline_microbatches", 0), **kwargs)
        whole = tnft.whole_nf_state(mesh, res["state"])
        out.update(flat(convert.to_jax_params(whole["params"]), name))
        out[f"{name}/bpd"] = np.asarray([res["results"]["bpd_test"],
                                         res["results"]["bpd_train"]])
    return out


def entry(job, mesh, d):
    """Both entry points with parallel.n_model in this process group, as
    torchrun starts them: a stage-1 epoch, its phase=eval, a stage-2 epoch
    of each named run and its phase=eval."""
    from nfdpm_tpu_torch import run_baseline, run_diffusion_prior

    os.environ["NFDPM_NO_TENSORBOARD"] = "1"
    os.chdir(d)
    out = {}
    res = run_baseline.main(job["entry"]["stage1"])
    out["stage1/bpd"] = np.asarray([res["results"]["bpd_test"], res["results"]["bpd_train"]])
    stage1_run = os.path.basename(res["run_dir"])
    res = run_baseline.main(job["entry"]["stage1"] + [
        "phase=eval", f"load.load_exp_dir={stage1_run}", "load.load_epoch=1"])
    out["stage1_eval/bpd"] = np.asarray([res["results"]["bpd_test"],
                                         res["results"]["bpd_train"]])
    for name, argv in job["entry"]["stage2"].items():
        argv = [a.replace("{stage1}", stage1_run) for a in argv]
        res = run_diffusion_prior.main(argv)
        out[f"{name}/vlb"] = np.asarray(res["vlb_bpd"])
        run = os.path.basename(res["run_dir"])
        res = run_diffusion_prior.main(argv + ["phase=eval", f"load.load_exp_dir={run}",
                                               "load.load_epoch=1"])
        out[f"{name}_eval/vlb"] = np.asarray(res["vlb_bpd"])
    return out


SCENARIOS = {"coords": coords, "layers": layers, "tp_steps": steps, "evaluation": evaluation,
             "checkpoints": checkpoints, "tp_entry": entry}
