"""Diffusion-prior experiment entry point (stage 2: NFBackbone + DiffusionPrior), PyTorch port.

    python -m nfdpm_tpu_torch.run_diffusion_prior \\
        model.normalizing_flow.init_nf.pretrain.dir=<stage-1 run dir under outputs/> \\
        model.normalizing_flow.init_nf.pretrain.epoch=10 data.name=synthetic ...

Counterpart of run_diffusion_prior_experiment.py over the same
configs/nf_diffusion.yaml and the same dotted overrides. It runs on the CUDA
device; `device=cpu` is the only way onto the CPU. The flow comes from a
stage-1 run directory of the port (`init_nf.mode=pretrain`, written by
nfdpm_tpu_torch.run_baseline) or from a seeded init (`scratch`); it is
frozen or co-trained (`freeze`, `lr`). One UNet and Gaussian diffusion per
latent part of the formater. With `standardize_latents` the latent stats
are fit once from the training stream, stored in diffusion_architecture.json
and read back on resume and eval. Phases:

  train: (optionally resumed) training with checkpoints and sample grids,
         then the variational-bound bits/dim of the test set
         ("VLB test bpd (diffusion prior)", `model.evaluation.vlb_batches`);
  eval:  the parameters of a checkpoint (load.load_exp_dir, load_epoch; the
         EMA weights when the run kept them) and the same bits/dim.

The configured sample metrics (FID/KID/SSIM_and_PSNR, as in
nfdpm_tpu_torch.run_baseline) run on the EMA weights where the run keeps
them, at checkpoint epochs and at the end of `train` and in `eval`.

`model.normalizing_flow.use_pallas` chooses the kernel route for the flow
and the UNets (the hand-written CUDA kernels on the card); true here unless
an override names it. `load.load_batch=k` resumes in the middle of epoch
`load.load_epoch` at batch k. Mixed precision, as in the JAX package:
`model.normalizing_flow.coupling_dtype=bfloat16` runs the flow's coupling
CNN in bf16 for this run (a pretrained flow or one from scratch; unset
keeps float32), and `model.diffusion.unet_dtype` (else `model.unet.dtype`)
the UNets' convolutions; the dtype travels as a string in
diffusion_architecture.json's unet_kwargs, and the file's "flow" entry
carries no coupling dtype. `model.training.matmul_precision` as in
nfdpm_tpu_torch.run_baseline.

Data parallelism as in nfdpm_tpu_torch.run_baseline (torchrun, one process
a GPU; `parallel.n_slices`; `parallel.fsdp` partitions the UNets' and the
flow's parameters, frozen or co-trained, with their moments and the EMA
shadow, each UNet block and Glow step gathering its weights on use). `parallel.part_parallel=true`
trains each diffusion part on its own group of ranks
(parallel/part_parallel.py; a frozen flow, no fsdp, no load.load_batch, as
in the JAX package); it writes the merged model_diffusion_* checkpoints
that phase=eval, runload and `serve --run-dir` read. `parallel.n_model=M`
makes the UNets and the flow tensor-parallel over blocks of M ranks, as in
nfdpm_tpu_torch.run_baseline, and inside each part's group under
part_parallel (a group's ranks must divide by M). `parallel.pipeline` and
`parallel.pipeline_microbatches` are stage-1 options and raise ValueError
here. `parallel.spatial=true` splits the flow transform's image rows over
the model axis in the train step, the flow whole on every rank and the
UNets tensor-parallel (nfdpm_tpu_torch.run_baseline's guard and warning;
refused beside part_parallel, as in the JAX package); the VLB, the
samplers and `phase=eval` run the whole flow. An orbax run directory of
the JAX package as the pretrained flow raises NotImplementedError
(tools/jax_run_to_torch.py converts one).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "nf_diffusion.yaml")
def refuse_pipeline(cfg) -> None:
    """Raise for the pipeline, which only the stage-1 trainer has."""
    from .run_baseline import pipeline_microbatches

    if pipeline_microbatches(cfg):
        raise ValueError("parallel.pipeline and parallel.pipeline_microbatches are "
                         "stage-1 options (nfdpm_tpu_torch.run_baseline): the diffusion "
                         "trainer has no pipeline")


def main(argv) -> dict:
    """Run the phase the overrides `argv` name; returns {"run_dir", "vlb_bpd",
    "vlb_n", "vlb_stderr"} and, with metrics configured, "metrics": the
    values of the final evaluation."""
    import nfdpm_tpu_torch as port
    from .convert import params_for_rank
    from .data.pipeline import read_dataset
    from .models import glow as glow_m
    from .models.diffusion_prior import DiffusionPrior
    from .models.formaters import get_formater, stats_from_json
    from .models.nf_backbone import NFBackbone, load_pretrained_flow
    from .parallel import mesh as mesh_m
    from .run_baseline import (load_batch, log_file, make_evaluate_fn, shared_run_dir,
                               start_parallel)
    from .training import diffusion_trainer as dt
    from .training.checkpoint import load_architecture, restore_params, save_architecture
    from .utils.config import load_config
    from .utils.env import log_environment, parse_train_eval_mode, set_seeds, setup_logger

    overrides = [a for a in argv if "=" in a]
    cfg = load_config(CONFIG, overrides)
    refuse_pipeline(cfg)
    nf_cfg = cfg.model.normalizing_flow
    fsdp = bool(cfg.select("parallel.fsdp", False))
    spatial = bool(cfg.select("parallel.spatial", False))
    part_parallel = bool(cfg.select("parallel.part_parallel", False))
    if part_parallel:  # the JAX package's refusals (run_diffusion_prior_experiment.py)
        if not bool(nf_cfg.freeze):
            raise ValueError("parallel.part_parallel requires a frozen flow (unfrozen "
                             "gradients couple the parts)")
        if fsdp or spatial:
            raise ValueError("parallel.part_parallel composes with n_model (in-group TP) "
                             "only — disable parallel.fsdp/parallel.spatial")
        if load_batch(cfg) is not None:
            raise ValueError("load.load_batch (mid-epoch resume) is not supported with "
                             "parallel.part_parallel — its checkpoints are epoch-level "
                             "(per-group states); resume with load.load_epoch only")
    mesh = start_parallel(cfg)
    use_kernels = (bool(nf_cfg.get("use_pallas", False)) if any(
        o.lstrip("+").startswith("model.normalizing_flow.use_pallas=") for o in overrides)
        else True)
    device = port.resolve_device(cfg.select("device"))
    port.set_matmul_precision(cfg.select("model.training.matmul_precision"))
    train_phase = parse_train_eval_mode(cfg.phase)

    run_dir = shared_run_dir(cfg, mesh)
    logger = setup_logger("base", log_file(run_dir, mesh))
    logger.info("Configuration:\n" + cfg.to_yaml())
    log_environment(logger, device)
    set_seeds(int(cfg.seed))

    img_size = int(cfg.data.img_size)
    in_channels = 1 if cfg.data.name == "MNIST" else 3
    frozen = bool(nf_cfg.freeze)
    # this run's coupling-CNN dtype, whatever the stage-1 run used; unset
    # keeps the pretrained flow's float32
    coupling_dtype = nf_cfg.get("coupling_dtype", None)
    if nf_cfg.init_nf.mode == "pretrain":
        pretrain_dir = os.path.join("outputs", str(nf_cfg.init_nf.pretrain.dir))
        backbone, flow_params = load_pretrained_flow(
            pretrain_dir, int(nf_cfg.init_nf.pretrain.epoch), frozen, device, use_kernels)
        if coupling_dtype:
            backbone = dataclasses.replace(backbone, cfg=dataclasses.replace(
                backbone.cfg, coupling_dtype=str(coupling_dtype)))
        logger.info(f"Loaded pretrained flow from {pretrain_dir}")
    elif nf_cfg.init_nf.mode == "scratch":
        sc = nf_cfg.init_nf.scratch
        gcfg = glow_m.GlowConfig(in_channels=in_channels, levels=int(sc.L), steps=int(sc.K),
                                 coupling_width=int(sc.get("coupling_width", 512)),
                                 coupling_dtype=str(coupling_dtype or "float32"),
                                 use_kernels=use_kernels)
        backbone = NFBackbone(cfg=gcfg, img_size=img_size, frozen=frozen)
        flow_params = glow_m.init_glow(int(cfg.seed), gcfg, device)
        logger.info("Initialized flow from scratch")
    else:
        raise ValueError(f"init_nf.mode must be 'pretrain' or 'scratch', "
                         f"got {nf_cfg.init_nf.mode!r}")
    if spatial:  # the model axis carries the train step's image rows, the flow whole
        mesh = mesh_m.spatial_for_training(mesh, backbone.img_size, backbone.cfg.levels,
                                           logger)

    formater = get_formater(nf_cfg.latent_formater)(
        L=backbone.cfg.levels, in_channels=backbone.cfg.in_channels, size=backbone.img_size)
    learned_variance = bool(cfg.select("model.diffusion.learned_variance", False))
    unet_kwargs = dict(
        dim=int(cfg.model.unet.dim), dim_mults=tuple(cfg.model.unet.dim_mults),
        resnet_block_groups=int(cfg.model.unet.resnet_block_groups),
        learned_sinusoidal_cond=bool(cfg.model.unet.learned_sinusoidal_cond),
        random_fourier_features=bool(cfg.model.unet.random_fourier_features),
        learned_sinusoidal_dim=int(cfg.model.unet.learned_sinusoidal_dim),
        learned_variance=learned_variance,
        # a string, so that diffusion_architecture.json carries it
        dtype=str(cfg.select("model.diffusion.unet_dtype",
                             cfg.select("model.unet.dtype", "float32"))))
    diffusion_kwargs = dict(
        timesteps=int(cfg.model.diffusion.timesteps),
        sampling_timesteps=int(cfg.model.diffusion.sampling_timesteps),
        loss_type=cfg.model.diffusion.loss_type,
        beta_schedule=cfg.model.diffusion.beta_schedule,
        ddim_sampling_eta=float(cfg.model.diffusion.ddim_sampling_eta),
        scan_unroll=int(cfg.select("model.diffusion.scan_unroll", 1)),
        sampling_method=str(cfg.select("model.diffusion.sampling_method", "auto")),
        vlb_time_chunk=int(cfg.select("model.diffusion.vlb_time_chunk", 4)),
        vlb_decoder=str(cfg.select("model.diffusion.vlb_decoder", "discretized")),
        vlb_clip_denoised=bool(cfg.select("model.diffusion.vlb_clip_denoised", True)),
        learned_variance=learned_variance,
        vlb_loss_weight=float(cfg.select("model.diffusion.vlb_loss_weight", 1.0)))

    tr = cfg.model.training
    tcfg = dt.DiffusionTrainConfig(
        epochs=int(tr.epochs),
        lr_diffusion=float(cfg.model.optimizer.lr),
        lr_nf=float(nf_cfg.lr) if nf_cfg.lr else None,
        optimizer=cfg.model.optimizer.type,
        n_bits=int(tr.n_bits),
        temperature=float(tr.temperature),
        print_freq=int(tr.print_freq),
        save_checkpoint_freq=int(tr.save_checkpoint_freq),
        log_gen_images_per_iter=int(cfg.model.logging.log_gen_images_per_iter),
        log_param_distribution=bool(cfg.model.logging.get("log_param_distribution", False)),
        compat_three_channel_bpd=bool(cfg.select("compat.three_channel_bpd", True)),
        ema_decay=(float(e) if (e := cfg.select("model.training.ema_decay")) else None),
        ema_update_every=int(cfg.select("model.training.ema_update_every", 10)),
        watchdog_timeout_s=(float(w) if (w := cfg.select(
            "model.training.watchdog_timeout_s")) else None),
        profile_epoch=(int(p) if (p := cfg.select("model.training.profile_epoch")) else None),
        profile_steps=int(cfg.select("model.training.profile_steps", 50)),
        lr_schedule=str(cfg.select("model.optimizer.schedule", "constant")),
        lr_warmup_steps=int(cfg.select("model.optimizer.warmup_steps", 0)),
        lr_decay_steps=(int(d) if (d := cfg.select("model.optimizer.decay_steps")) else None),
        lr_end_factor=float(cfg.select("model.optimizer.end_lr_factor", 0.0)),
    )

    loaders = read_dataset(
        cfg.data.name, cfg.data.root, digits=cfg.data.digits,
        batch_size=int(cfg.data.batch_size), img_size=img_size,
        transformations=list(cfg.data.transformations or []), seed=int(cfg.seed),
        synthetic_fallback=bool(cfg.data.get("synthetic_fallback", False)),
        synthetic_n=int(cfg.data.get("synthetic_n", 512)))

    resume_dir = cfg.load.load_exp_dir
    resume_epoch = int(cfg.load.load_epoch) if resume_dir else None
    resume_batch = load_batch(cfg)
    if resume_dir:
        resume_dir = os.path.join("outputs", resume_dir)

    # latent standardization: a resumed or evaluated run reads the stats its
    # diffusion models were trained with; a new run fits them once
    standardize = bool(cfg.select("model.normalizing_flow.standardize_latents", False))
    formater_stats = None
    if resume_dir:
        try:
            formater_stats = stats_from_json(load_architecture(
                resume_dir, "diffusion_architecture.json").get("formater_stats"))
        except FileNotFoundError:
            formater_stats = None
        if formater_stats is not None:
            logger.info(f"Loaded latent standardization stats from {resume_dir}")
        elif standardize:
            logger.warning(
                "standardize_latents=true requested but the resumed run at "
                f"{resume_dir} was trained without standardization stats; ignoring "
                "the flag to keep the restored diffusion params in their latent space.")
    elif standardize:
        formater_stats = dt.fit_latent_stats(
            backbone, flow_params, formater, tcfg, loaders.train,
            n_batches=int(cfg.select("model.normalizing_flow.standardize_batches", 8)),
            seed=int(cfg.seed), device=device, mesh=mesh)
    if formater_stats is not None:
        formater = formater.with_stats(formater_stats)
        logger.info("Latent standardization ON: sum(log std) over dims = "
                    f"{formater.stats_log_sigma_total():.1f} nats "
                    "(added back to every VLB NLL)")

    dp = DiffusionPrior(formater=formater, unet_kwargs=unet_kwargs,
                        diffusion_kwargs=diffusion_kwargs, use_kernels=use_kernels)
    if mesh_m.is_writer(mesh):
        save_architecture(run_dir, {
            "kind": "diffusion_prior",
            "flow": {"L": backbone.cfg.levels, "K": backbone.cfg.steps,
                     "in_channels": backbone.cfg.in_channels,
                     "coupling_width": backbone.cfg.coupling_width,
                     "learn_prior": backbone.cfg.learn_prior,
                     "invconv_param": backbone.cfg.invconv_param, "img_size": img_size},
            "formater": str(nf_cfg.latent_formater),
            "formater_stats": formater_stats,
            "unet_kwargs": {k: (list(v) if isinstance(v, tuple) else v)
                            for k, v in unet_kwargs.items()},
            "diffusion_kwargs": diffusion_kwargs,
            "frozen": frozen,
            "n_bits": int(tr.n_bits),
            "temperature": float(tr.temperature),
        }, filename="diffusion_architecture.json")

    evaluate_fn = make_evaluate_fn(cfg, loaders, logger, device, quick_num_gen=2000, mesh=mesh)
    vlb_batches = cfg.select("model.evaluation.vlb_batches", "full")
    vlb_batches = None if str(vlb_batches) == "full" else int(vlb_batches)

    def report_vlb(params, on=mesh):
        bpd, n, stderr = dt.calculate_bpd_with_diff_prior(
            backbone, dp, tcfg, params, loaders.test, int(cfg.seed),
            max_batches=vlb_batches, with_stats=True, device=device, mesh=on)
        logger.info(f"VLB test bpd (diffusion prior): {bpd:.4f} (N={n}, stderr={stderr:.4f})")
        return {"run_dir": run_dir, "vlb_bpd": bpd, "vlb_n": n, "vlb_stderr": stderr}

    if train_phase and part_parallel:
        from .parallel import part_parallel as pp

        out = pp.train_part_parallel(
            backbone=backbone, flow_params=flow_params, dp=dp, tcfg=tcfg, loaders=loaders,
            run_dir=run_dir, logger=logger, seed=int(cfg.seed), resume_dir=resume_dir,
            resume_epoch=resume_epoch, evaluate_fn=evaluate_fn, mesh=mesh, device=device)
        # the merged parts are whole: scored with every rank on the data axis
        return {**report_vlb(dt.ema_eval_params(out["state"]), mesh_m.flat(mesh)),
                **out["results"]}
    if train_phase:
        out = dt.train(backbone=backbone, flow_params=flow_params, dp=dp, tcfg=tcfg,
                       loaders=loaders, run_dir=run_dir, logger=logger, seed=int(cfg.seed),
                       resume_dir=resume_dir, resume_epoch=resume_epoch,
                       resume_batch=resume_batch, evaluate_fn=evaluate_fn, device=device,
                       mesh=mesh, fsdp=fsdp)
        return {**report_vlb(dt.eval_params(out["state"])), **out["results"]}
    else:
        if not resume_dir:
            raise ValueError("phase=eval requires load.load_exp_dir/load_epoch")
        # parameters only, the EMA weights where the run kept them
        params = restore_params(resume_dir, "diffusion", resume_epoch, device, prefer_ema=True)
        params["diffusion"] = {"parts": dp.unets_from_named(params["diffusion"]["parts"],
                                                            device)}
        params = params_for_rank(params, mesh)
        result = report_vlb(params)
        if evaluate_fn is not None:
            sample_fn = dt.make_sample_fn(backbone, dp, tcfg, int(cfg.seed), device, mesh)
            result["metrics"] = evaluate_fn(sample_fn, params, resume_epoch, full=True)
        return result


if __name__ == "__main__":
    from .parallel.distributed import shutdown

    t0 = time.time()
    try:
        main(sys.argv[1:])
    finally:
        shutdown()
    print(f"Experiment duration: {time.time() - t0:.1f}s")
