"""One rank of a data-parallel CPU test of nfdpm_tpu_torch (gloo).

    python tests/_torch_parallel_worker.py <job.json> <rank> <world>

Joins a gloo process group through a file:// rendezvous in the job's
directory, as a ("data", "model") mesh of the job's "n_model" and
"n_slices" (default 1: data parallelism alone; the model axis's scenarios
are tests/_torch_tp_scenarios.py, parameter partitioning's
tests/_torch_fsdp_scenarios.py, the pipeline's
tests/_torch_pipeline_scenarios.py, spatial partitioning's and split
GroupNorm's tests/_torch_spatial_scenarios.py, the UNet's remat
tests/_torch_unet_option_scenarios.py) (no TCP port, so that test
workers running side by side cannot collide), runs the job's scenarios in
order on the CPU and writes what each records to
<dir>/<scenario>_r<rank>.npz. Imports the port only (no
JAX): the tests compare what it writes with the JAX package in their own
process. Inputs (weights in the JAX layout, batches, injected draws) come
from the job's directory, written by the test.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nfdpm_tpu_torch import convert  # noqa: E402
from nfdpm_tpu_torch.parallel import distributed  # noqa: E402
from nfdpm_tpu_torch.parallel import mesh as mesh_m  # noqa: E402
from nfdpm_tpu_torch.parallel import sharding_rules as rules  # noqa: E402

import _torch_fsdp_scenarios  # noqa: E402
import _torch_pipeline_scenarios  # noqa: E402
import _torch_spatial_scenarios  # noqa: E402
import _torch_tp_scenarios  # noqa: E402
import _torch_unet_option_scenarios  # noqa: E402


def flat(tree, prefix):
    """{path: a copy}: a CPU tensor's numpy view would follow later steps."""
    out = {}
    convert._flatten(tree, prefix, out)
    return {k: np.array(v) for k, v in out.items()}


def glow_config(job, **kw):
    from nfdpm_tpu_torch.models import glow as tglow

    return tglow.GlowConfig(**{**job["glow"], **kw})


def stage1(job, mesh, d):
    """Stage-1 steps with the injected global noise (fsdp off and on) and
    with the step's own generator: bits/dim, parameters, moment shapes."""
    from nfdpm_tpu_torch.training import nf_trainer as tnft

    inputs = np.load(os.path.join(d, "stage1.npz"))
    tree = convert.load_npz(os.path.join(d, "stage1_tree.npz"))
    cfg = glow_config(job)
    out = {}
    for fsdp in (False, True):
        for mode in ("noise", "seed"):
            tcfg = tnft.NFTrainConfig(lr=1e-3)
            tx = tnft.optimizer_of(tcfg)
            params = convert.trainable(convert.from_jax_params(tree, "cpu"))
            state = tnft.shard_nf_state(mesh, tx, {"params": params, "opt_state": tx.init(params),
                                                   "step": 0}, fsdp)
            step = tnft.make_train_step(cfg, tcfg, tx, inject_noise=mode == "noise",
                                        device="cpu", mesh=mesh)
            tag = f"{mode}_fsdp{int(fsdp)}"
            bpds = []
            for i in range(3):
                rows = mesh_m.shard_batch(mesh, inputs["imgs"][i])
                state, m = step(state, rows, inputs["noise"][i] if mode == "noise" else 5)
                bpds.append(float(m["bpd"]))
                if i == 0:
                    out.update(flat(convert.to_jax_params(
                        tnft.whole_nf_state(mesh, state)["params"]), f"{tag}/step1"))
            out[f"{tag}/bpd"] = np.asarray(bpds)
            whole = tnft.whole_nf_state(mesh, state)["params"]
            out.update(flat(convert.to_jax_params(whole), f"{tag}/step3"))
            placements = state["layout"].placements if "layout" in state else {}
            params_by_path = dict(convert.named_leaves(whole))
            for path, t in convert.named_leaves(state["opt_state"]["mu"]):
                if path in placements:
                    want = placements[path].slab(params_by_path[path], mesh.rank).shape
                    out[f"{tag}/moment_shape/{path}"] = np.asarray(
                        [list(t.shape), list(want)])
            out[f"{tag}/moment_bytes"] = np.asarray(
                [rules.moment_bytes(state["opt_state"]),
                 rules.predicted_moment_bytes(whole, placements, mesh.rank)])
    return out


def stage2(job, mesh, d):
    """Stage-2 steps, frozen and co-trained, fsdp off and on, with the
    injected global draws: losses and parameters."""
    from nfdpm_tpu_torch.models import formaters as tfmt
    from nfdpm_tpu_torch.models.diffusion_prior import DiffusionPrior
    from nfdpm_tpu_torch.models.nf_backbone import NFBackbone
    from nfdpm_tpu_torch.training import diffusion_trainer as tdt

    out = {}
    for conf in job["stage2"]:
        name = conf["name"]
        inputs = np.load(os.path.join(d, f"stage2_{name}.npz"))
        tree = convert.load_npz(os.path.join(d, f"stage2_{name}_tree.npz"))
        formater = tfmt.get_formater(conf["formater"])(L=2, in_channels=3, size=job["img2"])
        dp = DiffusionPrior(formater, dict(job["unet"]), dict(job["diff"]))
        frozen = conf["frozen"]
        for fsdp in (False, True):
            tcfg = tdt.DiffusionTrainConfig(**conf["tcfg"])
            tx = tdt.make_two_group_optimizer(tcfg, frozen)
            bb = NFBackbone(glow_config(job, **job["glow2"]), job["img2"], frozen=frozen)
            params = convert.diffusion_from_jax_params(tree, dp, "cpu", requires_grad=True)
            params.pop("prior")
            state = {"params": params, "opt_state": tx.init(params), "step": 0}
            state = tdt.shard_diffusion_state(mesh, tx, state, fsdp)
            step = tdt.make_train_step(bb, dp, tcfg, tx, inject_noise=True, device="cpu",
                                       mesh=mesh)
            losses = []
            for i in range(len(inputs["imgs"])):
                draws = {"dequant": inputs[f"dequant_{i}"],
                         "parts": [{"t": inputs[f"t_{i}_{j}"], "noise": inputs[f"noise_{i}_{j}"],
                                    "self_cond": bool(inputs[f"coin_{i}_{j}"])}
                                   for j in range(dp.num_parts)]}
                state, m = step(state, mesh_m.shard_batch(mesh, inputs["imgs"][i]), draws)
                losses.append(float(m["loss"]))
            tag = f"{name}_fsdp{int(fsdp)}"
            out[f"{tag}/loss"] = np.asarray(losses)
            out.update(flat(convert.diffusion_to_jax_params(
                tdt.whole_diffusion_state(mesh, state)["params"]), f"{tag}/params"))
    return out


def resume(job, mesh, d):
    """Cross-topology resume: resume the checkpoint written at the other
    world size for one epoch, and write one of this world size."""
    import logging

    from nfdpm_tpu_torch.data import pipeline as tpipe
    from nfdpm_tpu_torch.training import nf_trainer as tnft

    os.environ["NFDPM_NO_TENSORBOARD"] = "1"
    cfg = glow_config(job)
    tcfg = tnft.NFTrainConfig(epochs=1, lr=1e-3, print_freq=100, save_checkpoint_freq=100)
    logger = logging.getLogger("resume")
    out = {}
    for name, kwargs in (("from_world1", dict(resume_dir=os.path.join(d, "world1_run"),
                                              resume_epoch=1)),
                         ("first_epoch", {})):
        loaders = tpipe.read_dataset("synthetic", "", batch_size=8, img_size=8, seed=0,
                                     synthetic_fallback=True, synthetic_n=32)
        res = tnft.train(cfg=cfg, tcfg=tcfg, loaders=loaders, run_dir=os.path.join(d, name),
                         logger=logger, seed=0, img_size=8, device="cpu", mesh=mesh, fsdp=True,
                         **kwargs)
        out.update(flat(convert.to_jax_params(
            tnft.whole_nf_state(mesh, res["state"])["params"]), name))
        out[f"{name}/bpd"] = np.asarray([res["results"]["bpd_test"],
                                         res["results"]["bpd_train"]])
    return out


def part_parallel(job, mesh, d):
    """The part-parallel trainer's plan over this launch: per-part losses and
    the merged parameters after each group's steps."""
    from nfdpm_tpu_torch.models import formaters as tfmt
    from nfdpm_tpu_torch.models import glow as tglow
    from nfdpm_tpu_torch.models.diffusion_prior import DiffusionPrior
    from nfdpm_tpu_torch.models.nf_backbone import NFBackbone
    from nfdpm_tpu_torch.parallel import part_parallel as pp
    from nfdpm_tpu_torch.training import diffusion_trainer as tdt

    inputs = np.load(os.path.join(d, "part.npz"))
    cfg = glow_config(job, **job["glow2"])
    formater = tfmt.get_formater("IdentityFormater")(L=2, in_channels=3, size=job["img2"])
    dp = DiffusionPrior(formater, dict(job["unet"]), dict(job["diff"]))
    flow = tglow.init_glow(0, cfg, "cpu")
    tcfg = tdt.DiffusionTrainConfig(lr_diffusion=1e-2, ema_decay=0.5, ema_update_every=1)
    plan = pp.PartParallelPlan.build(0, NFBackbone(cfg, job["img2"], frozen=True), flow, dp,
                                     tcfg, mesh)
    out = {}
    for i, batch in enumerate(inputs["imgs"]):
        g = i % dp.num_parts
        if plan.holds(g):
            loss = plan.step_group(g, batch, 7)
            if plan.groups[g].mesh.rank == 0:
                out[f"loss/{i}"] = np.asarray(float(loss))
    for prefer_ema in (False, True):
        merged = plan.joint_params(prefer_ema=prefer_ema)
        out.update(flat(convert.diffusion_to_jax_params(merged)["diffusion"],
                        f"ema{int(prefer_ema)}"))
    return out


def entry(job, mesh, d):
    """Both entry points in this process group, as `torchrun` starts them."""
    from nfdpm_tpu_torch import run_baseline, run_diffusion_prior

    os.environ["NFDPM_NO_TENSORBOARD"] = "1"
    os.chdir(d)
    out = {}
    res = run_baseline.main(job["entry"]["stage1"])
    out["stage1/bpd"] = np.asarray([res["results"]["bpd_test"], res["results"]["bpd_train"]])
    out["stage1/run_dir"] = np.asarray(os.path.basename(res["run_dir"]))
    stage1_run = os.path.basename(res["run_dir"])
    for name, argv in job["entry"]["stage2"].items():
        res = run_diffusion_prior.main([a.replace("{stage1}", stage1_run) for a in argv])
        out[f"{name}/vlb"] = np.asarray(res["vlb_bpd"])
        out[f"{name}/run_dir"] = np.asarray(os.path.basename(res["run_dir"]))
    return out


def sampling(job, mesh, d):
    """The trainers' samplers over the mesh: a Glow chunk and a stage-2 DDIM
    chunk of 5 (rows that do not divide), gathered on every rank."""
    from nfdpm_tpu_torch.models import formaters as tfmt
    from nfdpm_tpu_torch.models.diffusion_prior import DiffusionPrior
    from nfdpm_tpu_torch.models.nf_backbone import NFBackbone
    from nfdpm_tpu_torch.training import diffusion_trainer as tdt
    from nfdpm_tpu_torch.training import nf_trainer as tnft

    tree = convert.load_npz(os.path.join(d, "stage1_tree.npz"))
    glow = tnft.make_sample_fn(glow_config(job), tnft.NFTrainConfig(), 8, 3, "cpu", mesh)
    out = {"glow": glow(convert.from_jax_params(tree, "cpu"), 5, 0.8, 2).numpy()}
    tree2 = convert.load_npz(os.path.join(d, "stage2_frozen_tree.npz"))
    formater = tfmt.get_formater("IdentityFormater")(L=2, in_channels=3, size=job["img2"])
    dp = DiffusionPrior(formater, dict(job["unet"]), dict(job["diff"]))
    bb = NFBackbone(glow_config(job, **job["glow2"]), job["img2"], frozen=True)
    sample = tdt.make_sample_fn(bb, dp, tdt.DiffusionTrainConfig(), 3, "cpu", mesh)
    out["diffusion"] = sample(convert.diffusion_from_jax_params(tree2, dp, "cpu"), 5, 1.0,
                              2).numpy()
    return out


def features(job, mesh, d):
    """FID features of a batch that does not divide over the ranks (each
    rank its rows, all-gathered) with a seeded projection for a net."""
    from nfdpm_tpu_torch.metrics import fid

    images = np.load(os.path.join(d, "features.npz"))["images"]
    w = torch.from_numpy(np.load(os.path.join(d, "features.npz"))["w"])
    feats = fid.extract_features(images, lambda x: x.mean(dim=(1, 2)) @ w, 12, "legacy_tensorflow",
                                 batch_size=5, device="cpu", mesh=mesh)
    return {"feats": feats}


def gone(job, mesh, d):
    """Rank 1 stops answering (it sleeps, then leaves); rank 0's emergency
    save (the moments' all-gather, the barrier after the write) must raise
    with its rank's name within the time limit instead of hanging. Rank 0
    ends the process without leaving the group (a peer is gone)."""
    import time

    from nfdpm_tpu_torch.parallel import zero
    from nfdpm_tpu_torch.training import checkpoint as tckpt
    from nfdpm_tpu_torch.training import nf_trainer as tnft

    cfg = glow_config(job)
    tcfg = tnft.NFTrainConfig()
    tx = tnft.optimizer_of(tcfg)
    state = tnft.shard_nf_state(mesh, tx, tnft.init_train_state(0, cfg, tcfg, tx, "cpu"), True)
    mesh_m.barrier(mesh)
    if mesh.rank == 1:
        time.sleep(8.0)
        os._exit(0)
    out = {}
    for name, fn in (("gather", lambda: zero.whole_state(state, 3.0)),
                     ("barrier", lambda: tckpt.save_state(os.path.join(d, "gone"), "gaussian", 1,
                                                          {"step": 0}, mesh, 3.0))):
        t0 = time.monotonic()
        try:
            fn()
            out[f"{name}/error"] = np.asarray("")
        except RuntimeError as e:
            out[f"{name}/error"] = np.asarray(str(e))
        out[f"{name}/seconds"] = np.asarray(time.monotonic() - t0)
    np.savez(os.path.join(d, f"gone_r{mesh.rank}.npz"), **out)
    sys.stdout.flush()
    os._exit(0)


SCENARIOS = {"stage1": stage1, "stage2": stage2, "resume": resume,
             "part_parallel": part_parallel, "entry": entry, "sampling": sampling,
             "features": features, "gone": gone}
SCENARIOS.update(_torch_tp_scenarios.SCENARIOS)  # the model axis
SCENARIOS.update(_torch_fsdp_scenarios.SCENARIOS)  # parameters over the data axis
SCENARIOS.update(_torch_pipeline_scenarios.SCENARIOS)  # the pipeline
SCENARIOS.update(_torch_spatial_scenarios.SCENARIOS)  # image rows, split GroupNorm
SCENARIOS.update(_torch_unet_option_scenarios.SCENARIOS)  # the UNet's remat


def main() -> int:
    job_path, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    with open(job_path) as f:
        job = json.load(f)
    d = os.path.dirname(os.path.abspath(job_path))
    torch.set_num_threads(1)
    rules.FSDP_MIN_SIZE = job.get("fsdp_min_size", rules.FSDP_MIN_SIZE)
    distributed.initialize(backend="gloo", device="cpu", world_size=world, rank=rank,
                           init_method=f"file://{os.path.join(d, 'rendezvous')}")
    mesh = mesh_m.make_mesh(n_model=job.get("n_model", 1), n_slices=job.get("n_slices", 1),
                            device="cpu")
    for name in job["scenarios"]:
        out = SCENARIOS[name](job, mesh, d)
        np.savez(os.path.join(d, f"{name}_r{rank}.npz"), **out)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
