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
    (training/optim.py). `fsdp=True` partitions the parameters and Adam's
    moments over the data ranks (ZeRO stage 3, `shard_nf_state`,
    parallel/zero.py): each Glow step gathers its weights on use and its
    gradient comes back reduce-scattered. ddinit runs on every rank on the
    whole first global batch, before the cut. Rank 0 writes the checkpoints
    (whole parameters and moments), architecture.json, the mid-epoch marker
    and the tracker's files; evaluation and the samplers run on the
    gathered weights, the samples and the scores gathered from every rank's
    rows.
  * The model axis (a mesh with n_model > 1: tensor parallelism of the
    coupling CNNs, ops/coupling.py): each rank holds its slabs of the
    coupling CNNs' parameters and moments (`shard_nf_state`,
    parallel/sharding_rules.py glow_model_placements); the ranks of a
    model group hold the same rows and draw the same noise. ddinit runs on
    the slabs; the norm clip sums the slabs' squares over the model group;
    a checkpoint gathers every slab, so it holds the one-device layout and
    resumes at any (data, model) shape.
  * The pipeline (`pipeline_microbatches` > 0 under a model axis,
    parallel/pipeline.py): the model axis holds the stages, stage s the
    steps [s K/S, (s+1) K/S) of every level, and the flow forward is GPipe
    over the microbatches; no tensor parallelism. Evaluation, the samplers
    and checkpoints read the whole flow gathered from the stages.
  * Spatial partitioning (a spatial mesh, mesh.spatial_for_training;
    parallel/spatial.py): the model axis carries image rows, not slabs.
    Every model rank holds the whole flow and prior; the train step cuts
    the rows of its data block (and of the global dequantization draw) to
    its row block, runs the flow on them with halo exchanges, sums the
    log-likelihood's partial sums over the model group once, before
    bits/dim, and sums the gradients over the model group before the
    data-axis mean and the clips. ddinit, evaluation and the samplers run
    the whole flow, their rows split over every rank of the launch.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import apply_matmul_precision, inference, resolve_device
from ..convert import map_tree, named_leaves, trainable
from ..data.pipeline import DatasetLoaders, Loader, prefetch_to_device
from ..models import glow as glow_m
from ..models import prior as prior_m
from ..ops import quantize as q
from ..parallel import mesh as mesh_m
from ..parallel import pipeline as pl
from ..parallel import spatial as sp
from ..parallel.distributed import distribute_batch
from ..parallel import sharding_rules as rules
from ..parallel import tensor_parallel as tp
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
                       noise: Optional[torch.Tensor] = None, model=None) -> Dict[str, Any]:
    """A train state whose flow has every actnorm initialized from the
    statistics of `batch` (images in [0, 1] on the parameters' device),
    preprocessed and dequantized with `generator` or the U(0, 1) draw
    `noise`; fresh optimizer state, the step kept. `model`: the model axis
    when the state holds a rank's slabs."""
    x0 = q.dequantize(generator, q.preprocess(batch, tcfg.n_bits), tcfg.n_bits, noise)
    params = trainable({"flow": glow_m.ddinit(state["params"]["flow"], cfg, x0, model),
                        "prior": state["params"]["prior"]})
    return {"params": params, "opt_state": tx.init(params), "step": state["step"]}


def make_loss_fn(cfg: glow_m.GlowConfig, tcfg: NFTrainConfig, model=None, pp=None,
                 rows=None):
    """loss(params, batch, generator=None, noise=None, fsdp=None) -> (bits/dim
    scalar, log-likelihood [B]) of images `batch` in [0, 1], [B, H, W, C] on
    the parameters' device. `noise` is the U(0, 1) dequantization draw,
    added as noise / n_bins; else it comes from `generator`. `model`: the
    model axis when the parameters are a rank's slabs. `pp` = (mesh,
    microbatches): the flow forward pipelined over the mesh's model axis
    (the parameters a stage's). `fsdp`: the layout of parameters partitioned
    over the data axis (parallel/zero.Layout), whose units gather on use.
    `rows`: the model axis over which the images' rows split (spatial
    partitioning): the dequantized batch is cut to this rank's row block,
    and the log-likelihood's partial sums are summed over the model group
    (identity backward), so the loss is the whole images' on every rank."""
    n_bins = q.n_bins_of(tcfg.n_bits)

    def loss_fn(params, batch, generator=None, noise=None, fsdp=None):
        x = q.dequantize(generator, q.preprocess(batch, tcfg.n_bits), tcfg.n_bits, noise)
        if pp is not None:
            latents, ldj, logp = pl.pp_forward(params["flow"], cfg, x, pp[0], pp[1])
        else:
            latents, ldj, logp = glow_m.forward(params["flow"], cfg, sp.cut_rows(rows, x),
                                                model=model, rows=rows,
                                                fsdp=None if fsdp is None else fsdp.at("flow"))
        prior = params["prior"] if fsdp is None else fsdp.gather(params["prior"], "prior")
        ll = tp.reduce_from_model(
            rows, ldj + logp + prior_m.gaussian_prior_logp(prior, latents[-1]))
        n_pixel = prior_m.n_pixels(batch.shape[1], batch.shape[-1],
                                   tcfg.compat_three_channel_bpd)
        return prior_m.bits_per_dim(ll, n_bins, n_pixel), ll

    return loss_fn


def nf_placements(mesh, params, fsdp: bool) -> Dict[str, rules.Placement]:
    """The placements of a stage-1 state's parameters over the mesh's data
    axis ({} without `fsdp` or at one rank), computed on what the rank holds
    before the cut (its model slabs under a model axis; the whole flow under
    spatial partitioning): the JAX package's glow_param_specs and
    generic_param_specs (shard_nf_state)."""
    if not fsdp or mesh is None or mesh.n_data == 1:
        return {}
    n = mesh.n_data
    return {**rules.glow_placements(params["flow"], n, "flow",
                                    n_model=1 if mesh.spatial else mesh.n_model),
            **rules.generic_placements(params["prior"], n, "prior")}


def model_shard_nf_state(mesh, state) -> Dict[str, Any]:
    """A whole state made rank 0's on every rank (parameters broadcast) and
    cut to this rank's model slabs (parameters and moments)."""
    mesh_m.replicate(mesh, state["params"])
    return tp.shard_state(mesh_m.model_of(mesh), state,
                          rules.model_placements(mesh, state["params"]))


def partition_nf_state(mesh, state, fsdp: bool = False, pipeline: bool = False
                       ) -> Dict[str, Any]:
    """A state as model_shard_nf_state leaves it (whole under the pipeline)
    partitioned over an axis (parallel/zero.py keeps the layout): with
    `fsdp` its parameters and moments over the data axis (nf_placements),
    with `pipeline` the flow's steps over the stages of the model axis
    (pipeline.glow_pp_placements); as it is with neither."""
    pl.check_exclusive(pipeline, fsdp)
    if pipeline:
        return zero.shard_state(mesh, state, pl.glow_pp_placements(
            state["params"]["flow"], mesh.n_model), axis="model")
    return zero.shard_state(mesh, state, nf_placements(mesh, state["params"], fsdp))


def shard_nf_state(mesh, tx: Optimizer, state, fsdp: bool = False,
                   pipeline: bool = False) -> Dict[str, Any]:
    """A whole state made rank 0's on every rank, cut to this rank's model
    slabs under a model axis and, with `fsdp`, each partitioned leaf's
    parameter and moments cut to this rank's data slab (ZeRO stage 3,
    parallel/zero.py); with `pipeline`, the flow's steps placed on the
    stages of the model axis instead (no tensor parallelism). Works on fresh
    and restored states: nothing is re-initialized. `tx`, the state's
    optimizer, completes the JAX package's signature."""
    pl.check_exclusive(pipeline, fsdp)  # before any work, as the JAX package
    state = model_shard_nf_state(mesh_m.flat(mesh) if pipeline else mesh, state)
    return partition_nf_state(mesh, state, fsdp, pipeline)


def whole_nf_state(mesh, state, timeout_s: Optional[float] = None) -> Dict[str, Any]:
    """The state with whole parameters and moments (a partitioned state's
    parts gathered over its axis, then the model slabs over the model
    group): what a checkpoint holds, at any (data, model) shape and under
    the pipeline. A collective; each gather waits at most `timeout_s`
    seconds."""
    layout = state.get("layout")
    state = zero.whole_state(state, timeout_s)
    if layout is not None and layout.axis == "model":  # the pipeline's stages
        return state
    placements = rules.model_placements(mesh, state["params"])
    return tp.whole_state(mesh_m.model_of(mesh), state, placements, timeout_s)


def eval_params(state) -> Dict[str, Any]:
    """The parameters evaluation and the samplers read: a partitioned
    state's gathered whole over its axis (a collective), else the state's
    own."""
    return zero.whole_state(state, trees=("params",))["params"]


def make_train_step(cfg: glow_m.GlowConfig, tcfg: NFTrainConfig, tx: Optimizer,
                    inject_noise: bool = False, device=None, mesh=None, pp=None):
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
    are averaged over the ranks. A state partitioned over the data axis
    (shard_nf_state with fsdp) gathers each unit's weights on use and
    updates its slabs. Under a model axis the state holds the rank's model
    slabs (shard_nf_state) and the ranks of a model group take the same
    rows. `pp` = (mesh, microbatches) pipelines the flow over the mesh's
    model axis instead (the state from shard_nf_state with pipeline; no
    tensor parallelism). A spatial `mesh` (mesh.checked_spatial; the state
    whole on every model rank) splits the images' rows over its model axis
    (make_loss_fn's `rows`) and sums the gradients over the model group
    before the data-axis mean."""
    device = resolve_device(device)
    apply_matmul_precision()
    accum = max(1, int(tcfg.grad_accum))
    if accum > 1 and inject_noise:
        raise ValueError("grad_accum > 1 draws its noise per microbatch; "
                         "injected-noise runs must keep grad_accum=1")
    if pp is not None:
        mesh = pp[0]
    rows = mesh_m.rows_of(mesh)
    loss_fn = make_loss_fn(cfg, tcfg, None if pp is not None else mesh_m.flow_model_of(mesh),
                           pp, rows)
    generator = torch.Generator(device=device)
    model_placements = None  # computed at the first step

    def train_step(state, batch, seed_or_noise):
        nonlocal model_placements
        params = state["params"]
        layout = state.get("layout")
        fsdp = layout if layout is not None and layout.axis == "data" else None
        if model_placements is None:
            model_placements = (layout.placements if pp is not None else
                                rules.model_placements(mesh, params))
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
                bpd, ll = loss_fn(params, micro, noise=inference._on(device, noise), fsdp=fsdp)
            else:
                words = (_STEP, seed_or_noise, state["step"]) + ((i,) if accum > 1 else ())
                bpd, ll = loss_fn(params, micro, mesh_m.row_generator(
                    mesh, inference.reseed(generator, *words), micro.shape[0]), fsdp=fsdp)
            bpd.backward()  # the microbatches' gradients add up in .grad
            bpds.append(bpd.detach())
            lls.append(ll.detach().mean())
        if accum > 1:
            torch._foreach_div_([p.grad for p in leaves if p.grad is not None], accum)
        # each model rank's gradients are those of its rows' pixels
        sp.all_reduce_sum_(rows, [p.grad for p in leaves if p.grad is not None])
        metrics = {"bpd": torch.stack(bpds).mean(), "ll_mean": torch.stack(lls).mean()}
        # under the pipeline the other stages' steps are empty, with no gradient
        grads = grads_of(params) if pp is None else map_tree(
            params, lambda p: p.grad if p.grad is not None or not p.requires_grad
            else torch.zeros_like(p))
        opt_state = tx.apply(params, grads, state["opt_state"], mesh,
                             {} if fsdp is None else fsdp.placements,
                             extras=list(metrics.values()), model_placements=model_placements)
        out = {"params": params, "opt_state": opt_state, "step": state["step"] + 1}
        if layout is not None:
            out["layout"] = layout
        return out, metrics

    return train_step


def make_eval_step(cfg: glow_m.GlowConfig, tcfg: NFTrainConfig, device=None, model=None):
    """Per-example bits/dim of a batch (inference.make_eval_step: single
    dequantization draw, the log-likelihood as `eval_step.ll`); `model` the
    model axis when the parameters are a rank's slabs."""
    return inference.make_eval_step(cfg, tcfg.n_bits, tcfg.compat_three_channel_bpd, device,
                                    model)


def make_sample_fn(cfg: glow_m.GlowConfig, tcfg: NFTrainConfig, img_size: int, seed: int,
                   device=None, mesh=None):
    """sample_fn(params, n, temperature, salt) -> uint8 [n, H, W, C] on the
    device, a pure function of (seed, salt): the sampler of training's
    sample grids and of the metrics' `evaluate_fn`, in `train` and in
    phase=eval. With a data-parallel `mesh` each rank draws the whole
    chunk's noise, inverts its rows, and the rows are all-gathered: every
    rank returns the samples one device draws. Under a model axis the
    parameters are the rank's slabs and the ranks of a model group invert
    the same rows."""
    sample = inference.make_sample_fn(cfg, img_size, tcfg.n_bits, device,
                                      mesh_m.model_of(mesh))
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
          device=None, mesh=None, fsdp: bool = False,
          pipeline_microbatches: int = 0) -> Dict[str, Any]:
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
    `mesh` that save gathers the partitioned tensors and meets the other
    ranks within `watchdog_timeout_s` (else raises with the rank's name): a
    rank that is gone does not hang it.

    `mesh` (parallel/mesh.py) trains data-parallel, `fsdp=True` with the
    parameters and moments partitioned over the data axis (make_train_step);
    `pipeline_microbatches` > 0 pipelines the flow's steps over the model
    axis in that many microbatches (parallel/pipeline.py; without a model
    axis it warns and trains the plain step). A spatial `mesh`
    (mesh.spatial_for_training, which the entry point calls once: the JAX
    package's guard, or its warning without a model axis) makes the model
    axis carry the train step's image rows (parallel/spatial.py). A
    checkpoint holds
    whole tensors and resumes at any mesh shape."""
    device = resolve_device(device)
    apply_matmul_precision()
    tx = optimizer_of(tcfg)
    tracker = tracker_for(run_dir, mesh)
    writer = mesh_m.is_writer(mesh)
    start_epoch = 0

    n_model = mesh_m.n_model_of(mesh)
    pl.check_exclusive(pipeline_microbatches > 0, spatial=mesh_m.rows_of(mesh) is not None)
    pp = None
    if pipeline_microbatches > 0:
        if n_model > 1:
            accum = max(1, int(tcfg.grad_accum))
            pl.check_pipeline_config(cfg, n_model, pipeline_microbatches,
                                     loaders.train.batch_size // mesh.n_data // accum)
            pp = (mesh, pipeline_microbatches)
            logger.info(f"Pipeline parallelism: K={cfg.steps} over {n_model} stages, "
                        f"{pipeline_microbatches} microbatches")
        else:
            logger.warning("parallel.pipeline has no effect without a model axis "
                           "— set parallel.n_model>1")
    # the mesh of tensor parallelism, and of evaluation and sampling (whole
    # weights on every stage under the pipeline and on every model rank
    # under spatial partitioning)
    tp_mesh = mesh_m.flat(mesh) if pp is not None or mesh_m.rows_of(mesh) else mesh
    model = mesh_m.model_of(tp_mesh)
    if resume_dir is not None and resume_epoch is not None:
        state = restore_state(resume_dir, "gaussian", resume_epoch, device)
        state = model_shard_nf_state(tp_mesh, state)
        start_epoch = resume_epoch - 1 if resume_batch is not None else resume_epoch
        logger.info(f"Resumed from {resume_dir} @ epoch {resume_epoch}"
                    + (f" batch {resume_batch}" if resume_batch is not None else ""))
    else:
        state = model_shard_nf_state(tp_mesh, init_train_state(seed, cfg, tcfg, tx, device))
        # data-dependent actnorm init on one preprocessed batch (on the
        # rank's slabs under a model axis)
        init_imgs, _ = next(loaders.train.iter_epoch(0))
        state = ddinit_train_state(
            state, cfg, tcfg, tx, inference._on(device, init_imgs),
            inference.reseed(torch.Generator(device=device), _DDINIT, seed), model=model)
        logger.info("Data-dependent actnorm initialization done")
    state = partition_nf_state(mesh, state, fsdp, pp is not None)
    if mesh is not None:
        logger.info(f"Data parallel: {mesh}" + (", FSDP" if fsdp and "layout" in state else ""))
        if mesh.n_model > 1 or fsdp:
            logger.info(f"Param shardings applied: model axis={mesh.n_model}"
                        f"{', FSDP over data axis' if fsdp else ''}"
                        f"{' (pipeline layout)' if pp is not None else ''}")
    current_iter = state["step"]

    if writer:
        save_architecture(run_dir, {
            "L": cfg.levels, "K": cfg.steps, "in_channels": cfg.in_channels,
            "img_size": img_size, "coupling_width": cfg.coupling_width,
            "learn_prior": cfg.learn_prior, "n_bits": tcfg.n_bits,
            "fixed_prior": tcfg.compat_fixed_prior, "temperature": tcfg.temperature,
            "optimizer": tcfg.optimizer, "invconv_param": cfg.invconv_param})

    train_step = make_train_step(cfg, tcfg, tx, device=device, mesh=mesh, pp=pp)
    eval_step = make_eval_step(cfg, tcfg, device, model)
    sample_fn = make_sample_fn(cfg, tcfg, img_size, seed, device, tp_mesh)
    accum = max(1, int(tcfg.grad_accum))

    def save(epoch: int, timeout_s: Optional[float] = None) -> None:
        save_state(run_dir, "gaussian", epoch, whole_nf_state(mesh, state, timeout_s), mesh,
                   timeout_s)

    def rows_of(batches):
        for imgs, labels in batches:
            yield distribute_batch(mesh, imgs, accum), labels

    wd = StepWatchdog(tcfg.watchdog_timeout_s, run_dir=run_dir, logger=logger,
                      rank=None if mesh is None else mesh.rank)
    profiler = EpochProfiler(os.path.join(run_dir, "tb"), tcfg.profile_epoch,
                             tcfg.profile_steps, device, logger)
    log_count = 0
    epoch, iters_this_epoch, batches = start_epoch, 0, None
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
            batches = prefetch_to_device(rows_of(
                loaders.train.iter_epoch(epoch - 1, start_batch=skip)), device)
            for batch, _labels in batches:
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
                        samples = sample_fn(eval_params(state), tcfg.n_samples_log,
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
                tracker.track_param_distributions(eval_params(state), step=current_iter,
                                                  epoch=epoch)

            if epoch % tcfg.save_checkpoint_freq == 0:
                if evaluate_fn is not None:
                    evaluate_fn(sample_fn, eval_params(state), epoch)
                save(epoch)
                samples = sample_fn(eval_params(state), 64, tcfg.temperature, 2 * epoch)
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
    finally:  # whatever ends the loop, no watchdog, trace or producer thread outlives it
        wd.stop()
        profiler.end_epoch()
        if batches is not None:
            batches.close()

    final_epoch = start_epoch + tcfg.epochs
    save(final_epoch)
    if writer:
        clear_mid_epoch_marker(run_dir)  # the run completed

    params = eval_params(state)
    results = final_bpd(eval_step, params, loaders, seed, mesh=tp_mesh)
    for name, bpd in results.items():
        split = name.split("_", 1)[1]
        tracker.track(bpd, "bpd", epoch=final_epoch, context={"subset": split, "final": True})
        logger.info(f"final {split} bpd: {bpd:.4f}")
    if evaluate_fn is not None:
        results["metrics"] = evaluate_fn(sample_fn, params, final_epoch, full=True)

    tracker.close()
    return {"state": state, "results": results, "sample_fn": sample_fn}
