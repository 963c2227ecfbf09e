"""Baseline flow experiment entry point (Glow + Gaussian prior), PyTorch port.

    python -m nfdpm_tpu_torch.run_baseline data.name=synthetic model.architecture.L=3 ...

Counterpart of run_baseline_experiment.py over the same configs/nf_base.yaml
and the same dotted overrides. It runs on the CUDA device; `device=cpu` is
the only way onto the CPU. Phases:

  train: (optionally resumed) training with checkpoints, sample grids and
         final test/train bits/dim; `load.load_batch=k` resumes in the middle
         of epoch `load.load_epoch` at batch k, as an interrupt's emergency
         checkpoint logs it;
  eval:  restore a checkpoint's parameters (load.load_exp_dir, load_epoch)
         and compute test/train bits/dim, with
         model.evaluation.bpd_dequant_samples draws per image and, with
         bpd_iwae, the importance-weighted bound.

The configured sample metrics (model.evaluation.metrics.FID / KID as
parallel `mode` and `model_name` lists, SSIM_and_PSNR) run at checkpoint
epochs on `quick_num_gen` samples and, at the end of `train` and in
`eval`, on the dataset's full count (nfdpm_tpu_torch.metrics.compute), on
the same device, against stats that
`python -m nfdpm_tpu_torch.metrics.precompute_stats` writes.

`model.architecture.use_pallas` chooses the kernel route (the hand-written
CUDA kernels on the card). It is true here unless an override names it: the
file's own `false` is the JAX package's default, not the port's.
`model.architecture.coupling_dtype=bfloat16` runs the coupling CNN's two
inner convolutions in bf16 (fp32 master weights, Adam and logdet; see
ops/coupling.py). `model.training.matmul_precision` unset, "default" or
"highest" keeps cuDNN and cuBLAS in full fp32, "high" lets them use TF32
(nfdpm_tpu_torch.set_matmul_precision).

Data parallelism: one process per GPU, launched by torchrun,

    torchrun --nproc-per-node=N -m nfdpm_tpu_torch.run_baseline ...

(parallel/distributed.py; NCCL, or gloo with NFDPM_DIST_BACKEND=gloo). The
configured `data.batch_size` is the global batch, split over the ranks;
the numbers do not change with the world size. `parallel.n_model=M` makes
the launch a (world / M, M) ("data", "model") mesh: the coupling CNNs
tensor-parallel over each block of M consecutive ranks (parallel/mesh.py,
ops/coupling.py); M must divide the world (one process without a launch
cannot hold a model axis and raises). `parallel.fsdp=true` partitions the
parameters and Adam's moments over the data axis (ZeRO stage 3: each Glow
step gathers its weights on use, parallel/zero.py), `parallel.n_slices`
lays the data axis out slice-major. `parallel.pipeline=true` makes the
model axis a pipeline of M stages instead (parallel/pipeline.py): stage s
holds the steps [s K/M, (s+1) K/M) of every level and the flow runs GPipe
over `parallel.pipeline_microbatches` microbatches (0: M; a value set
without `parallel.pipeline` turns the pipeline on, as in the JAX package);
without a model axis it warns and trains the plain step. The pipeline
refuses fsdp, spatial partitioning and an explicit
`model.architecture.use_pallas=true`, with the JAX package's messages.
`parallel.spatial=true` makes the model axis carry the train step's image
rows instead of slabs of the flow (parallel/spatial.py: halo exchanges,
the flow whole on every rank), after the JAX package's guard
((img_size/2^L)/n_model >= 2 and divisible); without a model axis it warns
and trains the plain step; `phase=eval` runs the whole flow. Rank 0 writes
the run directory's files, with whole tensors at any mesh shape.
"""

from __future__ import annotations

import os
import sys
import time

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "nf_base.yaml")


def pipeline_microbatches(cfg) -> int:
    """The pipeline's microbatches the config asks for (0: no pipeline), as
    run_baseline_experiment.py maps them: `parallel.pipeline_microbatches`,
    or n_model when it is 0 and `parallel.pipeline` is set."""
    return (int(cfg.select("parallel.pipeline_microbatches", 0))
            or (int(cfg.select("parallel.n_model", 1))
                if bool(cfg.select("parallel.pipeline", False)) else 0))


def check_pipeline_options(cfg, overrides) -> int:
    """The pipeline's microbatches (0: none), after the JAX package's
    refusals of two layouts of the flow at once and of an explicit
    `use_pallas=true` (the JAX package cannot
    route its kernels inside the pipeline; the port's can, and takes them
    unless an override says false)."""
    from .parallel import pipeline as pl

    microbatches = pipeline_microbatches(cfg)
    if microbatches:
        pl.check_exclusive(True, bool(cfg.select("parallel.fsdp", False)),
                           bool(cfg.select("parallel.spatial", False)))
        if any(o.lstrip("+") == "model.architecture.use_pallas=true" for o in overrides):
            raise ValueError("use_pallas kernels are not routed inside the "
                             "pipeline region — disable one of the two")
    return microbatches


def start_parallel(cfg):
    """Join the launch's process group (parallel/distributed.py: torchrun's
    environment, or none) and return its ("data", "model") mesh, None for
    one process. `parallel.n_model` > 1 without a launch raises (the model
    axis needs n_model processes). Call before any CUDA use."""
    from .parallel import distributed
    from .parallel import mesh as mesh_m

    n_model = int(cfg.select("parallel.n_model", 1))
    if not distributed.initialize(device=cfg.select("device")):
        if n_model != 1:
            mesh_m.make_mesh(n_model=n_model, device="cpu")  # raises: one process
        return None
    return mesh_m.make_mesh(n_model=n_model,
                            n_slices=int(cfg.select("parallel.n_slices", 1)),
                            device=cfg.select("device"))


def shared_run_dir(cfg, mesh) -> str:
    """The run directory, made by rank 0 and named to every rank."""
    from .utils.config import make_run_dir

    if mesh is None or mesh.group is None:
        return make_run_dir(cfg)
    import torch.distributed as dist

    name = [make_run_dir(cfg) if mesh.rank == 0 else None]
    dist.broadcast_object_list(name, src=0, group=mesh.group)
    return name[0]


def log_file(run_dir: str, mesh) -> str:
    """train.log, or train_rank<r>.log on a rank other than 0."""
    return os.path.join(run_dir, "train.log" if mesh is None or mesh.rank == 0
                        else f"train_rank{mesh.rank}.log")


def load_batch(cfg):
    """`load.load_batch` of a resumed run, or None: the batch of epoch
    `load.load_epoch` after which an interrupt wrote its checkpoint."""
    batch = cfg.select("load.load_batch")
    return int(batch) if cfg.load.load_exp_dir and batch is not None else None


def make_evaluate_fn(cfg, loaders, logger, device, quick_num_gen: int, mesh=None):
    """The trainers' `evaluate_fn` for the configured FID/KID/SSIM_and_PSNR
    metrics, or None when none is configured."""
    from .utils.config import parse_metric

    fid_cfgs = parse_metric(cfg.select("model.evaluation.metrics.FID"))
    kid_cfgs = parse_metric(cfg.select("model.evaluation.metrics.KID"))
    ssim_cfg = cfg.select("model.evaluation.metrics.SSIM_and_PSNR")
    if not (fid_cfgs or kid_cfgs or ssim_cfg):
        return None
    from .metrics.compute import make_nf_evaluate_fn

    return make_nf_evaluate_fn(
        data_name=cfg.data.name, loaders=loaders, fid_configs=fid_cfgs,
        kid_configs=kid_cfgs, img_size=int(cfg.data.img_size),
        temperature=float(cfg.model.training.temperature), logger=logger,
        ssim_psnr=dict(ssim_cfg) if ssim_cfg else None,
        quick_num_gen=int(cfg.select("model.evaluation.quick_num_gen", quick_num_gen)),
        dataset_split=str(cfg.select("model.evaluation.dataset_split", "train")),
        gen_batch_size=int(cfg.select("model.evaluation.gen_batch_size", 256)),
        device=device, mesh=mesh)


def main(argv) -> dict:
    """Run the phase the overrides `argv` name; returns {"run_dir",
    "results"}: the final bits/dim ("bpd_test", "bpd_train") and, with
    metrics configured, their values under "metrics"."""
    import nfdpm_tpu_torch as port
    from .convert import params_for_rank
    from .data.pipeline import read_dataset
    from .models import glow as glow_m
    from .parallel import mesh as mesh_m
    from .training import nf_trainer as nft
    from .training.checkpoint import restore_params
    from .utils.config import load_config
    from .utils.env import log_environment, parse_train_eval_mode, set_seeds, setup_logger

    overrides = [a for a in argv if "=" in a]
    cfg = load_config(CONFIG, overrides)
    microbatches = check_pipeline_options(cfg, overrides)
    use_kernels = (bool(cfg.model.architecture.use_pallas) if any(
        o.lstrip("+").startswith("model.architecture.use_pallas=") for o in overrides)
        else True)
    fsdp = bool(cfg.select("parallel.fsdp", False))
    spatial = bool(cfg.select("parallel.spatial", False))

    arch = cfg.model.architecture
    gcfg = glow_m.GlowConfig(
        in_channels=1 if cfg.data.name == "MNIST" else 3,
        levels=int(arch.L),
        steps=int(arch.K),
        coupling_width=int(arch.get("coupling_width", 512)),
        learn_prior=bool(arch.learn_prior_mean_logs),
        scan_unroll=int(arch.get("scan_unroll", 4)),
        coupling_dtype=str(arch.get("coupling_dtype", "float32")),
        remat=bool(arch.get("remat", False)),
        use_kernels=use_kernels,
    )
    n_model = int(cfg.select("parallel.n_model", 1))
    if microbatches:  # the guards that need no launch
        from .parallel.pipeline import check_pipeline_config

        check_pipeline_config(gcfg, n_model, microbatches)
    if spatial and n_model > 1:
        mesh_m.check_spatial(int(cfg.data.img_size), gcfg.levels, n_model)
    mesh = start_parallel(cfg)
    device = port.resolve_device(cfg.select("device"))
    port.set_matmul_precision(cfg.select("model.training.matmul_precision"))
    train_phase = parse_train_eval_mode(cfg.phase)
    tr = cfg.model.training
    tcfg = nft.NFTrainConfig(
        epochs=int(tr.epochs),
        lr=float(cfg.model.optimizer.lr),
        optimizer=cfg.model.optimizer.type,
        n_bits=int(tr.n_bits),
        temperature=float(tr.temperature),
        print_freq=int(tr.print_freq),
        save_checkpoint_freq=int(tr.save_checkpoint_freq),
        log_gen_images_per_iter=int(cfg.model.logging.log_gen_images_per_iter),
        log_param_distribution=bool(cfg.model.logging.get("log_param_distribution", False)),
        compat_three_channel_bpd=bool(cfg.select("compat.three_channel_bpd", True)),
        compat_fixed_prior=bool(cfg.select("compat.fixed_prior", True)),
        grad_accum=int(cfg.select("model.training.grad_accum", 1)),
        watchdog_timeout_s=(float(w) if (w := cfg.select(
            "model.training.watchdog_timeout_s")) else None),
        profile_epoch=(int(p) if (p := cfg.select(
            "model.training.profile_epoch")) else None),
        profile_steps=int(cfg.select("model.training.profile_steps", 50)),
        lr_schedule=str(cfg.select("model.optimizer.schedule", "constant")),
        lr_warmup_steps=int(cfg.select("model.optimizer.warmup_steps", 0)),
        lr_decay_steps=(int(d) if (d := cfg.select(
            "model.optimizer.decay_steps")) else None),
        lr_end_factor=float(cfg.select("model.optimizer.end_lr_factor", 0.0)),
    )

    run_dir = shared_run_dir(cfg, mesh)
    logger = setup_logger("base", log_file(run_dir, mesh))
    logger.info("Configuration:\n" + cfg.to_yaml())
    log_environment(logger, device)
    set_seeds(int(cfg.seed))

    loaders = read_dataset(
        cfg.data.name,
        cfg.data.root,
        digits=cfg.data.digits,
        batch_size=int(cfg.data.batch_size),
        img_size=int(cfg.data.img_size),
        transformations=list(cfg.data.transformations or []),
        seed=int(cfg.seed),
        synthetic_fallback=bool(cfg.data.get("synthetic_fallback", False)),
        synthetic_n=int(cfg.data.get("synthetic_n", 512)),
    )

    evaluate_fn = make_evaluate_fn(cfg, loaders, logger, device, quick_num_gen=15, mesh=mesh)
    resume_dir = cfg.load.load_exp_dir
    resume_epoch = int(cfg.load.load_epoch) if resume_dir else None
    resume_batch = load_batch(cfg)
    if resume_dir:
        resume_dir = os.path.join("outputs", resume_dir)

    if train_phase:
        if spatial:  # the model axis carries the train step's image rows, the flow whole
            mesh = mesh_m.spatial_for_training(mesh, int(cfg.data.img_size), gcfg.levels,
                                               logger)
        out = nft.train(
            cfg=gcfg, tcfg=tcfg, loaders=loaders, run_dir=run_dir, logger=logger,
            seed=int(cfg.seed), img_size=int(cfg.data.img_size),
            resume_dir=resume_dir, resume_epoch=resume_epoch, resume_batch=resume_batch,
            evaluate_fn=evaluate_fn, device=device, mesh=mesh, fsdp=fsdp,
            pipeline_microbatches=microbatches)
        logger.info(f"Training done: {out['results']}")
        return {"run_dir": run_dir, "results": out["results"]}
    else:
        if not resume_dir:
            raise ValueError("phase=eval requires load.load_exp_dir/load_epoch")
        # params-only restore: needs no optimizer, so runs trained with any
        # optimizer and schedule evaluate
        if microbatches or spatial:  # train-step layouts: whole weights here
            mesh = mesh_m.flat(mesh)
        params = params_for_rank(restore_params(resume_dir, "gaussian", resume_epoch, device),
                                 mesh)
        k_deq = int(cfg.select("model.evaluation.bpd_dequant_samples", 1))
        iwae = bool(cfg.select("model.evaluation.bpd_iwae", False))
        eval_step = nft.make_eval_step(gcfg, tcfg, device, None if mesh is None else mesh.model)
        results = nft.final_bpd(eval_step, params, loaders,
                                int(cfg.seed), n_dequant_samples=k_deq, iwae=iwae, mesh=mesh)
        tag = f" (K={k_deq}{', iwae' if iwae else ''})" if k_deq > 1 else ""
        for name, bpd in results.items():
            logger.info(f"{name.split('_', 1)[1]} bpd{tag}: {bpd:.4f}")
        if evaluate_fn is not None:
            sample_fn = nft.make_sample_fn(gcfg, tcfg, int(cfg.data.img_size), int(cfg.seed),
                                           device, mesh)
            results["metrics"] = evaluate_fn(sample_fn, params, resume_epoch, full=True)
        return {"run_dir": run_dir, "results": results}


if __name__ == "__main__":
    from .parallel.distributed import shutdown

    t0 = time.time()
    try:
        main(sys.argv[1:])
    finally:
        shutdown()
    print(f"Experiment duration: {time.time() - t0:.1f}s")
