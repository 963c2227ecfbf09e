"""Normalizing-flow (Glow + Gaussian prior) training loop.

Counterpart of nfdpm_tpu/training/nf_trainer.py, in eager PyTorch:

  * `make_train_step` carries the hot path: 5-bit preprocess, uniform
    dequantization, flow forward, prior log-density, bits/dim, backward,
    value clip 1 and global-norm clip 1, the Adam update. On a CUDA device
    the channel mix and the coupling tail run through the hand-written
    kernels in both directions (ops/kernels/) unless
    `GlowConfig.use_kernels` is False. The step returns its metrics as
    device scalars; the loop fetches them only every `print_freq` steps.
  * The dequantization draw of step n is a pure function of (seed, n): one
    device generator is reseeded from them each step, so a resumed run
    replays the noise of the uninterrupted one.
  * Data-dependent actnorm init is the `glow.ddinit` pass on the first
    preprocessed and dequantized batch.
  * Checkpoints (training/checkpoint.py) every `save_checkpoint_freq`
    epochs and at the end; resume restores parameters, optimizer state and
    step at an epoch boundary or, after an interrupt, in the middle of an
    epoch (`resume_batch`, from checkpoints/mid_epoch.json).
  * An interrupt (Ctrl-C, or the hung-step watchdog of
    `watchdog_timeout_s`, utils/watchdog.py) writes an emergency checkpoint
    of the steps taken and the mid-epoch marker; `profile_epoch` traces
    `profile_steps` steps of that epoch into <run_dir>/tb/profile/
    (utils/profiling.py); each epoch logs its step time's p50 and p95.
  * `calculate_bpd` scores a loader with one or several dequantization
    draws per image, averaged or importance-weighted (IWAE).
  * Data parallelism (`mesh=`, parallel/mesh.py): every rank loads the
    same global batch and keeps its rows; the step's dequantization draw is
    the global batch's, of which each rank keeps its rows, so the numbers
    do not change with the world size. The gradient mean is one all-reduce
    (training/optim.py). `fsdp=True` partitions Adam's moments over the
    ranks (ZeRO, `shard_nf_state`). ddinit runs on every rank on the whole
    first global batch. Rank 0 writes the checkpoints (with whole moments),
    architecture.json, the mid-epoch marker and the tracker's files; the
    samples and the scores are gathered from every rank's rows.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import apply_matmul_precision, inference, resolve_device
from ..convert import named_leaves, trainable
from ..data.pipeline import DatasetLoaders, Loader, prefetch_to_device
from ..models import glow as glow_m
from ..models import prior as prior_m
from ..ops import quantize as q
from ..parallel import mesh as mesh_m
from ..parallel.distributed import distribute_batch
from ..parallel import sharding_rules as rules
from ..parallel import zero
from ..utils.profiling import EpochProfiler, StepTimer
from ..utils.watchdog import StepWatchdog, interrupt_after_block
from .checkpoint import (clear_mid_epoch_marker, restore_state, save_architecture,
                         save_mid_epoch_marker, save_state)
from .optim import Optimizer, grads_of, make_lr_schedule, make_optimizer
from .tracking import tracker_for

# First words of the seeds of the trainer's generators, so that the streams
# of the train steps, ddinit, the evaluations and the sample grids never
# coincide (inference.reseed).
_STEP, _DDINIT, _EVAL, _SAMPLES = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class NFTrainConfig:
    epochs: int = 10
    lr: float = 1e-3
    optimizer: str = "adam"
    lr_schedule: str = "constant"  # "constant" (+ optional warmup) or "cosine"
    lr_warmup_steps: int = 0
    lr_decay_steps: Optional[int] = None  # cosine: total steps incl. warmup
    lr_end_factor: float = 0.0            # cosine: end LR = lr * factor
    n_bits: int = 5
    temperature: float = 1.0
    print_freq: int = 50
    save_checkpoint_freq: int = 5
    log_gen_images_per_iter: int = 2
    n_samples_log: int = 8
    log_param_distribution: bool = False  # per-epoch param histograms
    compat_three_channel_bpd: bool = True  # count 3 channels per pixel even
    # for 1-channel images, as the published bits/dim do
    compat_fixed_prior: bool = True  # optimize and clip the flow's leaves
    # only: the final Gaussian prior stays standard normal. False trains it.
    profile_epoch: Optional[int] = None  # trace that epoch's first
    profile_steps: int = 50               # profile_steps steps
    watchdog_timeout_s: Optional[float] = None  # hung-step detection
    grad_accum: int = 1  # microbatches per optimizer step: the batch is
    # split into `grad_accum` slices, gradients averaged, one update


def optimizer_of(tcfg: NFTrainConfig) -> Optimizer:
    """The optimizer a train config names."""
    return make_optimizer(
        tcfg.optimizer, tcfg.lr, fixed_prior=tcfg.compat_fixed_prior,
        lr_schedule=make_lr_schedule(tcfg.lr, tcfg.lr_schedule, tcfg.lr_warmup_steps,
                                     tcfg.lr_decay_steps, tcfg.lr_end_factor))


def init_train_state(seed, cfg: glow_m.GlowConfig, tcfg: NFTrainConfig, tx: Optimizer,
                     device=None) -> Dict[str, Any]:
    """{"params": {"flow", "prior"} as autograd leaves, "opt_state", "step"}
    on `device` (CUDA unless named). `seed`: an int or a numpy Generator."""
    device = resolve_device(device)
    params = trainable({
        "flow": glow_m.init_glow(seed, cfg, device),
        "prior": prior_m.init_gaussian_prior(glow_m.final_channels(cfg), cfg.learn_prior,
                                             device)})
    return {"params": params, "opt_state": tx.init(params), "step": 0}


def ddinit_train_state(state: Dict[str, Any], cfg: glow_m.GlowConfig, tcfg: NFTrainConfig,
                       tx: Optimizer, batch: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """A train state whose flow has every actnorm initialized from the
    statistics of `batch` (images in [0, 1] on the parameters' device),
    preprocessed and dequantized with `generator` or the U(0, 1) draw
    `noise`; fresh optimizer state, the step kept."""
    x0 = q.dequantize(generator, q.preprocess(batch, tcfg.n_bits), tcfg.n_bits, noise)
    params = trainable({"flow": glow_m.ddinit(state["params"]["flow"], cfg, x0),
                        "prior": state["params"]["prior"]})
    return {"params": params, "opt_state": tx.init(params), "step": state["step"]}


def make_loss_fn(cfg: glow_m.GlowConfig, tcfg: NFTrainConfig):
    """loss(params, batch, generator=None, noise=None) -> (bits/dim scalar,
    log-likelihood [B]) of images `batch` in [0, 1], [B, H, W, C] on the
    parameters' device. `noise` is the U(0, 1) dequantization draw, added as
    noise / n_bins; else it comes from `generator`."""
    n_bins = q.n_bins_of(tcfg.n_bits)

    def loss_fn(params, batch, generator=None, noise=None):
        x = q.dequantize(generator, q.preprocess(batch, tcfg.n_bits), tcfg.n_bits, noise)
        latents, ldj, logp = glow_m.forward(params["flow"], cfg, x)
        ll = ldj + logp + prior_m.gaussian_prior_logp(params["prior"], latents[-1])
        n_pixel = prior_m.n_pixels(batch.shape[1], batch.shape[-1],
                                   tcfg.compat_three_channel_bpd)
        return prior_m.bits_per_dim(ll, n_bins, n_pixel), ll

    return loss_fn


def nf_placements(mesh, tx: Optimizer, params, fsdp: bool) -> Dict[str, rules.Placement]:
    """ZeRO placements of the train state's updated leaves over the mesh's
    data axis ({} without `fsdp` or at one rank): the JAX package's
    glow_param_specs and generic_param_specs (shard_nf_state)."""
    if not fsdp or mesh is None or mesh.n_data == 1:
        return {}
    n = mesh.n_data
    return rules.trained_placements({**rules.glow_placements(params["flow"], n, "flow"),
                                     **rules.generic_placements(params["prior"], n, "prior")},
                                    tx)


def shard_nf_state(mesh, tx: Optimizer, state, fsdp: bool = False) -> Dict[str, Any]:
    """The state made rank 0's on every rank (parameters broadcast) and,
    with `fsdp`, each partitioned leaf's moments cut to this rank's slab
    (ZeRO, parallel/sharding_rules.py). Works on fresh and restored states:
    the moments are sliced, never re-initialized."""
    mesh_m.replicate(mesh, state["params"])
    return zero.shard_state(mesh, state, nf_placements(mesh, tx, state["params"], fsdp))


def make_train_step(cfg: glow_m.GlowConfig, tcfg: NFTrainConfig, tx: Optimizer,
                    inject_noise: bool = False, device=None, mesh=None, fsdp: bool = False):
    """Build train_step(state, batch, seed) -> (state, metrics).

    The state's parameters and moments are updated in place; the returned
    state shares them and carries the raised step and optimizer count. The
    dequantization noise of a step comes from a generator reseeded from
    (`seed`, state["step"]) (and the microbatch index under `grad_accum`),
    so it depends on nothing else. `metrics` = {"bpd", "ll_mean"} are
    scalars on the device: reading them waits for the step.

    `inject_noise=True` takes the U(0, 1) dequantization draw itself as the
    third argument instead of the seed, so that a test can give this step
    and the JAX package's the same noise; it needs grad_accum = 1.

    With a data-parallel `mesh`, `batch` is this rank's rows
    (mesh.shard_batch of the global batch, microbatch by microbatch); the
    noise is drawn for the global batch (an injected draw is the global
    batch's too) and cut to the rank's rows; the gradients and the metrics
    are averaged over the ranks. `fsdp=True` takes the ZeRO path for the
    leaves nf_placements partitions; the state must come from
    shard_nf_state."""
    device = resolve_device(device)
    apply_matmul_precision()
    accum = max(1, int(tcfg.grad_accum))
    if accum > 1 and inject_noise:
        raise ValueError("grad_accum > 1 draws its noise per microbatch; "
                         "injected-noise runs must keep grad_accum=1")
    loss_fn = make_loss_fn(cfg, tcfg)
    generator = torch.Generator(device=device)
    placements = None  # computed at the first step, from the parameters' shapes

    def train_step(state, batch, seed_or_noise):
        nonlocal placements
        params = state["params"]
        if placements is None:
            placements = nf_placements(mesh, tx, params, fsdp)
        leaves = [p for _, p in named_leaves(params) if p.requires_grad]
        for p in leaves:
            p.grad = None
        batch = inference._on(device, batch)
        if batch.shape[0] % accum:
            raise ValueError(f"batch of {batch.shape[0]} does not split into "
                             f"{accum} microbatches")
        bpds, lls = [], []
        for i, micro in enumerate(batch.chunk(accum)):
            if inject_noise:
                noise = seed_or_noise
                if mesh is not None:
                    noise = noise[mesh_m.data_sharding(mesh, len(noise))]
                bpd, ll = loss_fn(params, micro, noise=inference._on(device, noise))
            else:
                words = (_STEP, seed_or_noise, state["step"]) + ((i,) if accum > 1 else ())
                bpd, ll = loss_fn(params, micro, mesh_m.row_generator(
                    mesh, inference.reseed(generator, *words), micro.shape[0]))
            bpd.backward()  # the microbatches' gradients add up in .grad
            bpds.append(bpd.detach())
            lls.append(ll.detach().mean())
        if accum > 1:
            torch._foreach_div_([p.grad for p in leaves if p.grad is not None], accum)
        metrics = {"bpd": torch.stack(bpds).mean(), "ll_mean": torch.stack(lls).mean()}
        opt_state = tx.apply(params, grads_of(params), state["opt_state"], mesh, placements,
                             extras=list(metrics.values()))
        return {"params": params, "opt_state": opt_state, "step": state["step"] + 1}, metrics

    return train_step


def make_eval_step(cfg: glow_m.GlowConfig, tcfg: NFTrainConfig, device=None):
    """Per-example bits/dim of a batch (inference.make_eval_step: single
    dequantization draw, the log-likelihood as `eval_step.ll`)."""
    return inference.make_eval_step(cfg, tcfg.n_bits, tcfg.compat_three_channel_bpd, device)


def make_sample_fn(cfg: glow_m.GlowConfig, tcfg: NFTrainConfig, img_size: int, seed: int,
                   device=None, mesh=None):
    """sample_fn(params, n, temperature, salt) -> uint8 [n, H, W, C] on the
    device, a pure function of (seed, salt): the sampler of training's
    sample grids and of the metrics' `evaluate_fn`, in `train` and in
    phase=eval. With a data-parallel `mesh` each rank draws the whole
    chunk's noise, inverts its rows, and the rows are all-gathered: every
    rank returns the samples one device draws."""
    sample = inference.make_sample_fn(cfg, img_size, tcfg.n_bits, device)
    generator = torch.Generator(device=sample.device)

    def sample_fn(params, n: int, temperature: float, salt: int) -> torch.Tensor:
        return mesh_m.sample_rows(
            mesh, n, inference.reseed(generator, _SAMPLES, seed, salt),
            lambda rows, g: sample(params, rows, temperature, generator=g))

    return sample_fn


def calculate_bpd(eval_step, params, loader: Loader, seed: int,
                  n_dequant_samples: int = 1, iwae: bool = False, mesh=None) -> float:
    """Mean bits/dim over a loader, padded batches with the pad masked out.
    Draw r of batch i comes from a generator seeded from (seed, 131 i + r).

    `n_dequant_samples > 1` tightens the dequantization bound with several
    uniform draws: `iwae=False` averages the per-draw bounds; `iwae=True`
    takes the importance-weighted log (1/K) sum_k p(x + u_k) =
    logsumexp(ll_k) - log K, the tighter bound.

    With a data-parallel `mesh` each rank scores its rows of every batch
    with the global batch's draws, and the per-image values are
    all-gathered before the sums: every rank returns the same mean."""
    device = eval_step.device
    total, count = 0.0, 0
    for i, (imgs, _labels, n_valid) in enumerate(loader.padded_batches()):
        rows = imgs if mesh is None else imgs[mesh_m.data_sharding(mesh, len(imgs))]
        batch = inference._on(device, rows)
        draws = [mesh_m.row_generator(mesh, inference.reseed(
                     torch.Generator(device=device), _EVAL, seed, i * 131 + r), len(rows))
                 for r in range(n_dequant_samples)]
        if iwae and n_dequant_samples > 1:
            n_pixel = prior_m.n_pixels(batch.shape[1], batch.shape[-1], eval_step.compat)
            lls = torch.stack([eval_step.ll(params, batch, g) for g in draws])
            ll = torch.logsumexp(lls, dim=0) - np.log(n_dequant_samples)
            bpds = (np.log(eval_step.n_bins) * n_pixel - ll) * (np.log2(np.e) / n_pixel)
            total += float(mesh_m.all_gather_rows(mesh, bpds)[:n_valid].sum())
        else:
            acc = sum(mesh_m.all_gather_rows(mesh, eval_step(params, batch, g))[:n_valid].sum()
                      for g in draws)
            total += float(acc) / n_dequant_samples
        count += n_valid
    return total / max(count, 1)


def final_bpd(eval_step, params, loaders: DatasetLoaders, seed: int,
              n_dequant_samples: int = 1, iwae: bool = False, mesh=None) -> Dict[str, float]:
    """{"bpd_test", "bpd_train"}: `calculate_bpd` of the test loader and of
    the eval loader (train data under the test transforms), each with its
    own seed. Training's last evaluation and `phase=eval` both call this, so
    the second reproduces the first from the same seed and weights."""
    return {f"bpd_{split}": calculate_bpd(eval_step, params, loader, seed * 2 + fold,
                                          n_dequant_samples, iwae, mesh)
            for fold, (split, loader) in enumerate((("test", loaders.test),
                                                    ("train", loaders.eval)))}


def train(*, cfg: glow_m.GlowConfig, tcfg: NFTrainConfig, loaders: DatasetLoaders,
          run_dir: str, logger, seed: int = 42, img_size: int = 32,
          resume_dir: Optional[str] = None, resume_epoch: Optional[int] = None,
          resume_batch: Optional[int] = None, evaluate_fn=None,
          device=None, mesh=None, fsdp: bool = False) -> Dict[str, Any]:
    """The whole training run, on `device` (CUDA unless named).
    `evaluate_fn(sample_fn, params, epoch)` is an optional hook for sample
    metrics at checkpoint epochs and, with `full=True`, at the end.

    Resume: `resume_epoch=E` (with `resume_batch=None`) means E epochs are
    complete in `resume_dir`: training continues at epoch E+1 and, because
    each epoch's data order is a pure function of (seed, epoch) and each
    step's noise one of (seed, step), repeats exactly what the uninterrupted
    run would have done. `resume_batch=k` means the checkpoint was written
    in the middle of epoch E after k batches (the interrupt path records it
    in checkpoints/mid_epoch.json): epoch E is re-entered at batch k and
    counts as the first of `tcfg.epochs`. Both continue bit for bit.

    An interrupt (KeyboardInterrupt, also the watchdog's) saves the state of
    the steps taken as epoch E's checkpoint, writes the marker and is raised
    again; a run that completes removes the marker. Under a data-parallel
    `mesh` that save gathers the moments and meets the other ranks within
    `watchdog_timeout_s` (else raises with the rank's name): a rank that is
    gone does not hang it.

    `mesh` (parallel/mesh.py) trains data-parallel, `fsdp=True` with ZeRO
    moments (make_train_step); a checkpoint resumes at any world size."""
    device = resolve_device(device)
    apply_matmul_precision()
    tx = optimizer_of(tcfg)
    tracker = tracker_for(run_dir, mesh)
    writer = mesh_m.is_writer(mesh)
    start_epoch = 0

    if resume_dir is not None and resume_epoch is not None:
        state = restore_state(resume_dir, "gaussian", resume_epoch, device)
        start_epoch = resume_epoch - 1 if resume_batch is not None else resume_epoch
        logger.info(f"Resumed from {resume_dir} @ epoch {resume_epoch}"
                    + (f" batch {resume_batch}" if resume_batch is not None else ""))
    else:
        state = init_train_state(seed, cfg, tcfg, tx, device)
        # data-dependent actnorm init on one preprocessed batch
        init_imgs, _ = next(loaders.train.iter_epoch(0))
        state = ddinit_train_state(
            state, cfg, tcfg, tx, inference._on(device, init_imgs),
            inference.reseed(torch.Generator(device=device), _DDINIT, seed))
        logger.info("Data-dependent actnorm initialization done")
    state = shard_nf_state(mesh, tx, state, fsdp)
    placements = nf_placements(mesh, tx, state["params"], fsdp)
    if mesh is not None:
        logger.info(f"Data parallel: {mesh}" + (", ZeRO moments" if placements else ""))
    current_iter = state["step"]

    if writer:
        save_architecture(run_dir, {
            "L": cfg.levels, "K": cfg.steps, "in_channels": cfg.in_channels,
            "img_size": img_size, "coupling_width": cfg.coupling_width,
            "learn_prior": cfg.learn_prior, "n_bits": tcfg.n_bits,
            "fixed_prior": tcfg.compat_fixed_prior, "temperature": tcfg.temperature,
            "optimizer": tcfg.optimizer, "invconv_param": cfg.invconv_param})

    train_step = make_train_step(cfg, tcfg, tx, device=device, mesh=mesh, fsdp=fsdp)
    eval_step = make_eval_step(cfg, tcfg, device)
    sample_fn = make_sample_fn(cfg, tcfg, img_size, seed, device, mesh)
    accum = max(1, int(tcfg.grad_accum))

    def save(epoch: int, timeout_s: Optional[float] = None) -> None:
        save_state(run_dir, "gaussian", epoch,
                   zero.whole_state(mesh, state, placements, timeout_s), mesh, timeout_s)

    def rows_of(batches):
        for imgs, labels in batches:
            yield distribute_batch(mesh, imgs, accum), labels

    wd = StepWatchdog(tcfg.watchdog_timeout_s, run_dir=run_dir, logger=logger,
                      rank=None if mesh is None else mesh.rank)
    profiler = EpochProfiler(os.path.join(run_dir, "tb"), tcfg.profile_epoch,
                             tcfg.profile_steps, device, logger)
    log_count = 0
    epoch, iters_this_epoch = start_epoch, 0
    try:
        for epoch in range(start_epoch + 1, start_epoch + tcfg.epochs + 1):
            t0 = time.time()
            timer = StepTimer()
            pending = []  # device scalars; fetched only at print_freq
            skip = resume_batch if resume_batch is not None and epoch == resume_epoch else 0
            iters_this_epoch = skip
            wd.start()  # watches the step loop only: the checkpoint epoch's
            # evaluation and save below may take longer than a step timeout
            profiler.start_epoch(epoch)
            for batch, _labels in prefetch_to_device(rows_of(
                    loaders.train.iter_epoch(epoch - 1, start_batch=skip)), device):
                with interrupt_after_block():
                    with timer.step():
                        state, metrics = train_step(state, batch, seed)
                    current_iter += 1
                    iters_this_epoch += 1
                wd.beat()
                profiler.step()
                pending.append(metrics["bpd"])

                if current_iter % tcfg.print_freq == 0:
                    avg = float(torch.stack(pending).mean())
                    wd.beat_sync()  # the fetch waited for the steps
                    pending = []
                    tracker.track(avg, "bpd", step=current_iter, epoch=epoch,
                                  context={"subset": "train"})
                    logger.info(f"epoch {epoch} iter {current_iter}: bpd {avg:.4f}")
                    log_count += 1
                    if (log_count % tcfg.log_gen_images_per_iter == 0) and epoch % 5 == 0:
                        samples = sample_fn(state["params"], tcfg.n_samples_log,
                                            tcfg.temperature, 2 * current_iter + 1)
                        tracker.track_images(samples.cpu().numpy(), "generated",
                                             step=current_iter, epoch=epoch)

            wd.stop()
            profiler.end_epoch()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.time() - t0
            ts = timer.summary()
            logger.info(f"epoch {epoch} done in {dt:.1f}s "
                        f"({len(loaders.train) / max(dt, 1e-9):.2f} it/s, "
                        f"step p50 {ts.get('p50_ms', 0):.1f}ms p95 {ts.get('p95_ms', 0):.1f}ms)")
            if tcfg.log_param_distribution:
                tracker.track_param_distributions(state["params"], step=current_iter,
                                                  epoch=epoch)

            if epoch % tcfg.save_checkpoint_freq == 0:
                if evaluate_fn is not None:
                    evaluate_fn(sample_fn, state["params"], epoch)
                save(epoch)
                samples = sample_fn(state["params"], 64, tcfg.temperature, 2 * epoch)
                tracker.track_images(samples.cpu().numpy(), "checkpoint_samples",
                                     step=current_iter, epoch=epoch)
    except KeyboardInterrupt:
        wd.stop()
        save(epoch, tcfg.watchdog_timeout_s if mesh is not None else None)
        if writer:
            save_mid_epoch_marker(run_dir, "gaussian", epoch, iters_this_epoch)
        logger.warning(("Watchdog stall: " if wd.fired else "Interrupted: ")
                       + f"emergency checkpoint at epoch {epoch} batch {iters_this_epoch}; "
                       f"resume bit for bit with load.load_epoch={epoch} "
                       f"load.load_batch={iters_this_epoch}")
        raise
    finally:  # whatever ends the loop, no watchdog or trace outlives it
        wd.stop()
        profiler.end_epoch()

    final_epoch = start_epoch + tcfg.epochs
    save(final_epoch)
    if writer:
        clear_mid_epoch_marker(run_dir)  # the run completed

    results = final_bpd(eval_step, state["params"], loaders, seed, mesh=mesh)
    for name, bpd in results.items():
        split = name.split("_", 1)[1]
        tracker.track(bpd, "bpd", epoch=final_epoch, context={"subset": split, "final": True})
        logger.info(f"final {split} bpd: {bpd:.4f}")
    if evaluate_fn is not None:
        results["metrics"] = evaluate_fn(sample_fn, state["params"], final_epoch, full=True)

    tracker.close()
    return {"state": state, "results": results, "sample_fn": sample_fn}
