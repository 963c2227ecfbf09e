"""Diffusion-prior training loop (stage 2): NFBackbone + DiffusionPrior.

Counterpart of nfdpm_tpu/training/diffusion_trainer.py, in eager PyTorch:

  * `make_train_step`: 5-bit preprocess and uniform dequantization, the flow
    transform (no split-prior log-densities), the per-part diffusion losses
    summed, plus `nf_bpd_weight` times the flow's bits/dim term when the
    flow co-trains; backward; the two-group Adam update, no clipping. On a
    CUDA device the flow's channel mix and coupling tail and the UNets'
    linear-attention blocks run through the hand-written kernels, forward
    and backward, unless their configs turn them off. A frozen flow runs
    under torch.no_grad(): no graph and no gradient kernels for it. The
    draws of step n (dequantization, and per part the timesteps, the noise
    and the self-conditioning coin) are a pure function of (seed, n), or
    injected.
  * `make_two_group_optimizer`: {"diffusion": lr_diffusion, "flow": lr_nf
    when the flow co-trains and lr_nf is set, else no update}, p_mat and sign
    never updated, each group on the schedule at its own peak rate.
  * EMA of the trainable parameters (the UNets, plus the flow when it
    co-trains), inside the step (`ema_update_every=1`) or every k steps, with
    the warm-up min(decay, (1 + n) / (10 + n)); sampling and evaluation read
    `ema_eval_params`.
  * Checkpoints every `save_checkpoint_freq` epochs and at the end (a
    UNet saved as the dict of its parameters by name); resume at an epoch
    boundary or in the middle of one (`resume_batch`), the EMA kept,
    dropped or seeded as the run asks.
  * An interrupt (Ctrl-C, or the hung-step watchdog of
    `watchdog_timeout_s`) writes an emergency checkpoint of the steps taken,
    EMA included, and the mid-epoch marker; `profile_epoch` traces
    `profile_steps` steps of that epoch into <run_dir>/tb/profile/; each
    epoch logs its step time's p50 and p95, as in nf_trainer.
  * `calculate_bpd_with_diff_prior`: the variational bound in bits/dim over
    a loader, with its standard error; `fit_latent_stats` for latent
    standardization.
  * Data parallelism (`mesh=`, as in nf_trainer): each rank keeps its rows
    of the global batch; the step's draws (dequantization, each part's t
    and noise) are the global batch's, cut to the rank's rows; the
    self-conditioning coin is shared. `fsdp=True` partitions the Adam
    moments of the UNets and of a co-trained flow (`shard_diffusion_state`);
    a frozen flow has none. The EMA shadow stays whole and equal on every
    rank. Sampling, the VLB and the latent stats gather or sum what the
    ranks computed on their rows.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import apply_matmul_precision, inference, resolve_device
from ..convert import map_tree, named_leaves, trainable
from ..data.pipeline import DatasetLoaders, Loader, prefetch_to_device
from ..models import prior as prior_m
from ..models.diffusion_prior import DiffusionPrior
from ..models.formaters import fit_formater_stats
from ..models.nf_backbone import NFBackbone
from ..ops import quantize as q
from ..parallel import mesh as mesh_m
from ..parallel.distributed import distribute_batch
from ..parallel import sharding_rules as rules
from ..parallel import zero
from ..utils.profiling import EpochProfiler, StepTimer
from ..utils.watchdog import StepWatchdog, interrupt_after_block
from .checkpoint import (clear_mid_epoch_marker, restore_state, save_mid_epoch_marker,
                         save_state)
from .optim import Optimizer, make_lr_schedule
from .tracking import tracker_for

# First words of the seeds of the trainer's generators (inference.reseed):
# the train steps, the evaluations, the sample grids, the latent stats. They
# differ from the flow trainer's (0-3).
_STEP, _EVAL, _SAMPLES, _STATS = 4, 5, 6, 7


@dataclasses.dataclass(frozen=True)
class DiffusionTrainConfig:
    epochs: int = 10
    lr_diffusion: float = 1e-3
    lr_nf: Optional[float] = None      # used when the flow is unfrozen
    optimizer: str = "adam"
    lr_schedule: str = "constant"  # both groups, each at its own peak rate
    lr_warmup_steps: int = 0
    lr_decay_steps: Optional[int] = None  # cosine: total steps incl. warmup
    lr_end_factor: float = 0.0            # cosine: end LR = lr * factor
    n_bits: int = 5
    temperature: float = 1.0
    print_freq: int = 50
    save_checkpoint_freq: int = 5
    log_gen_images_per_iter: int = 20
    n_samples_log: int = 8
    log_param_distribution: bool = False  # per-epoch param histograms
    nf_bpd_weight: float = 0.5  # weight of the flow's bits/dim when it co-trains
    compat_three_channel_bpd: bool = True  # count 3 channels per pixel even
    # for 1-channel images, as the published bits/dim do
    ema_decay: Optional[float] = None  # e.g. 0.9995: EMA of the trainable params
    profile_epoch: Optional[int] = None  # trace that epoch's first
    profile_steps: int = 50               # profile_steps steps
    watchdog_timeout_s: Optional[float] = None  # hung-step detection
    ema_update_every: int = 10  # 1: the EMA update inside the step; k > 1:
    # every k-th step, its warm-up counting updates (n = step // k)


def make_two_group_optimizer(tcfg: DiffusionTrainConfig, frozen: bool) -> Optimizer:
    """Adam or AdamW without clipping: `lr_diffusion` for the "diffusion"
    leaves, `lr_nf` for the "flow" leaves when the flow co-trains and lr_nf
    is set, otherwise no update of the flow (optax.set_to_zero)."""
    if tcfg.optimizer not in ("adam", "adamw"):
        raise ValueError(f"Unknown optimizer: {tcfg.optimizer}")

    def schedule(lr):
        return make_lr_schedule(lr, tcfg.lr_schedule, tcfg.lr_warmup_steps,
                                tcfg.lr_decay_steps, tcfg.lr_end_factor)

    flow = None if frozen or tcfg.lr_nf is None else schedule(tcfg.lr_nf)
    return Optimizer(groups={"diffusion": schedule(tcfg.lr_diffusion), "flow": flow},
                     name=tcfg.optimizer, clip_value=None, clip_norm=None)


def _n_pixel(backbone: NFBackbone, tcfg: DiffusionTrainConfig) -> float:
    return prior_m.n_pixels(backbone.img_size, backbone.cfg.in_channels,
                            tcfg.compat_three_channel_bpd)


def make_loss_fn(backbone: NFBackbone, dp: DiffusionPrior, tcfg: DiffusionTrainConfig):
    """loss(params, batch, generator=None, draws=None) -> (scalar loss, the
    per-part losses [parts], detached) for images `batch` in [0, 1],
    [B, H, W, C] on the parameters' device. `draws` = {"dequant": the U(0, 1)
    dequantization draw, "parts": [{"t", "noise", "self_cond"}, ...]}
    (DiffusionPrior.losses); what is not injected comes from `generator`."""
    n_pixel = _n_pixel(backbone, tcfg)

    def loss_fn(params, batch, generator=None, draws=None):
        x = q.dequantize(generator, q.preprocess(batch, tcfg.n_bits), tcfg.n_bits,
                         None if draws is None else draws["dequant"])
        latents, ldj = backbone.transform(params["flow"], x)
        losses = dp.losses(params["diffusion"], latents, generator,
                           None if draws is None else draws["parts"])
        loss = sum(losses)
        if not backbone.frozen:
            loss = loss + tcfg.nf_bpd_weight * torch.mean(-ldj / (math.log(2.0) * n_pixel))
        return loss, torch.stack([part.detach() for part in losses])

    return loss_fn


def _draws_on(device: torch.device, draws: Dict[str, Any]) -> Dict[str, Any]:
    def put(v, dtype):
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.array(v))
        return v.to(device=device, dtype=dtype)

    return {"dequant": put(draws["dequant"], torch.float32),
            "parts": [{"t": put(p["t"], torch.int64), "noise": put(p["noise"], torch.float32),
                       "self_cond": p.get("self_cond")} for p in draws["parts"]]}


# -- EMA ---------------------------------------------------------------------

def _ema_subtree(params, frozen: bool) -> Dict[str, Any]:
    """What the EMA shadows: the UNets, plus the flow when it co-trains."""
    if frozen:
        return {"diffusion": params["diffusion"]}
    return {"flow": params["flow"], "diffusion": params["diffusion"]}


def _ema_copy(params, frozen: bool) -> Dict[str, Any]:
    """A detached copy of the shadowed subtree (the UNets as modules without
    gradients)."""
    out = {"diffusion": {"parts": [copy.deepcopy(u).requires_grad_(False)
                                   for u in params["diffusion"]["parts"]]}}
    if not frozen:
        out["flow"] = map_tree(params["flow"], lambda t: t.detach().clone())
    return out


@torch.no_grad()
def _ema_lerp_(ema, params, frozen: bool, decay: float, n: int) -> None:
    """ema <- ema + (1 - d) (params - ema), d = min(decay, (1 + n) / (10 + n))
    in fp32, in place."""
    n32 = np.float32(n)
    d = np.minimum(np.float32(decay), (np.float32(1.0) + n32) / (np.float32(10.0) + n32))
    live = _ema_subtree(params, frozen)
    shadow = [t for key in live for _, t in named_leaves(ema[key])]
    current = [t.detach() for key in live for _, t in named_leaves(live[key])]
    if len(shadow) != len(current):
        raise ValueError("the EMA shadow does not match the trained parameters")
    torch._foreach_add_(shadow, torch._foreach_sub(current, shadow),
                        alpha=float(np.float32(1.0) - d))


def make_ema_update(backbone: NFBackbone, tcfg: DiffusionTrainConfig):
    """apply(state) -> state with the shadow moved toward the live params, in
    place, its warm-up counting updates (n = step // ema_update_every)."""
    k = max(1, int(tcfg.ema_update_every))

    def apply(state):
        _ema_lerp_(state["ema"], state["params"], backbone.frozen, tcfg.ema_decay,
                   state["step"] // k)
        return state

    return apply


def ema_eval_params(state) -> Dict[str, Any]:
    """The parameters with the EMA weights where they are tracked; the live
    ones when the state has no EMA. Sampling and evaluation read these."""
    ema = state.get("ema")
    if ema is None:
        return state["params"]
    return {"flow": ema.get("flow", state["params"]["flow"]), "diffusion": ema["diffusion"]}


# -- the step ----------------------------------------------------------------

def init_train_state(seed: int, backbone: NFBackbone, flow_params, dp: DiffusionPrior,
                     tx: Optimizer, ema: bool = False, device=None) -> Dict[str, Any]:
    """{"params": {"flow", "diffusion": {"parts": [Unet, ...]}}, "opt_state",
    "step"} (and "ema") on `device` (CUDA unless named): the UNets seeded
    (seed + part), the flow's parameters autograd leaves when it co-trains."""
    device = resolve_device(device)
    flow = flow_params if backbone.frozen else trainable(flow_params)
    params = {"flow": flow, "diffusion": dp.init_params(seed, device, requires_grad=True)}
    state = {"params": params, "opt_state": tx.init(params), "step": 0}
    if ema:
        state["ema"] = _ema_copy(params, backbone.frozen)
    return state


def diffusion_placements(mesh, tx: Optimizer, params, fsdp: bool
                         ) -> Dict[str, rules.Placement]:
    """ZeRO placements of the updated leaves ({} without `fsdp` or at one
    rank): each UNet by the JAX package's unet_param_specs, a co-trained
    flow by glow_param_specs; a frozen flow is not optimized and keeps no
    moments to partition (shard_diffusion_state)."""
    if not fsdp or mesh is None or mesh.n_data == 1:
        return {}
    n = mesh.n_data
    out = rules.glow_placements(params["flow"], n, "flow")
    for i, unet in enumerate(params["diffusion"]["parts"]):
        out.update(rules.unet_placements(unet, n, f"diffusion/parts/{i}"))
    return rules.trained_placements(out, tx)


def shard_diffusion_state(mesh, tx: Optimizer, state, fsdp: bool = False) -> Dict[str, Any]:
    """The state made rank 0's on every rank (parameters and EMA shadow
    broadcast) and, with `fsdp`, the partitioned leaves' moments cut to
    this rank's slab."""
    mesh_m.replicate(mesh, state["params"])
    if "ema" in state:
        mesh_m.replicate(mesh, state["ema"])
    return zero.shard_state(mesh, state, diffusion_placements(mesh, tx, state["params"], fsdp))


def _draw_rows(draws: Dict[str, Any], rows: slice) -> Dict[str, Any]:
    """The rank's rows of injected global draws (the coin is shared)."""
    return {"dequant": draws["dequant"][rows],
            "parts": [{**part, "t": part["t"][rows], "noise": part["noise"][rows]}
                      for part in draws["parts"]]}


def make_train_step(backbone: NFBackbone, dp: DiffusionPrior, tcfg: DiffusionTrainConfig,
                    tx: Optimizer, inject_noise: bool = False, device=None, mesh=None,
                    fsdp: bool = False):
    """Build train_step(state, batch, seed) -> (state, metrics).

    The parameters, moments and EMA shadow are updated in place; the
    returned state shares them and carries the raised step and count. The
    draws of a step come from a generator reseeded from (`seed`,
    state["step"]). `inject_noise=True` takes the draws themselves as the
    third argument (make_loss_fn's `draws`), so that a test can give this
    step and the JAX package's the same numbers. `metrics` = {"loss",
    "part_losses"} are device tensors: reading them waits for the step.

    With a data-parallel `mesh`, `batch` is this rank's rows; the draws are
    the global batch's (injected ones too) cut to them, and the gradients
    and the metrics are averaged over the ranks; `fsdp=True` takes the ZeRO
    path (the state from shard_diffusion_state)."""
    device = resolve_device(device)
    apply_matmul_precision()
    loss_fn = make_loss_fn(backbone, dp, tcfg)
    generator = torch.Generator(device=device)
    in_step_ema = tcfg.ema_decay is not None and tcfg.ema_update_every <= 1
    placements = None  # computed at the first step, from the parameters' shapes

    def train_step(state, batch, seed_or_draws):
        nonlocal placements
        params = state["params"]
        if placements is None:
            placements = diffusion_placements(mesh, tx, params, fsdp)
        for _, p in named_leaves(params):
            p.grad = None
        batch = inference._on(device, batch)
        if inject_noise:
            draws = seed_or_draws
            if mesh is not None:
                draws = _draw_rows(draws, mesh_m.data_sharding(mesh, len(draws["dequant"])))
            loss, parts = loss_fn(params, batch, draws=_draws_on(device, draws))
        else:
            loss, parts = loss_fn(params, batch, mesh_m.row_generator(mesh, inference.reseed(
                generator, _STEP, seed_or_draws, state["step"]), batch.shape[0]))
        loss.backward()
        # a trained leaf the loss does not reach (a co-trained flow's split
        # priors) has no .grad: a zero gradient, as jax.grad gives it
        grads = map_tree(params, lambda p: p.grad if p.grad is not None or not p.requires_grad
                         else torch.zeros_like(p))
        loss = loss.detach()
        opt_state = tx.apply(params, grads, state["opt_state"], mesh, placements,
                             extras=[loss, parts])
        out = {"params": params, "opt_state": opt_state, "step": state["step"] + 1}
        if "ema" in state:
            if in_step_ema:
                _ema_lerp_(state["ema"], params, backbone.frozen, tcfg.ema_decay,
                           state["step"])
            out["ema"] = state["ema"]
        return out, {"loss": loss, "part_losses": parts}

    return train_step


def make_sample_fn(backbone: NFBackbone, dp: DiffusionPrior, tcfg: DiffusionTrainConfig,
                   seed: int, device=None, mesh=None):
    """sample_fn(params, n, temperature, salt) -> uint8 [n, H, W, C] on the
    device: diffusion latents, then the flow inverse; a pure function of
    (seed, salt). The sampler of training's sample grids and of the
    metrics' `evaluate_fn`, in `train` and in phase=eval. With a
    data-parallel `mesh` each rank draws the whole chunk's noise, runs the
    chains and the inverse on its rows, and the rows are all-gathered."""
    device = resolve_device(device)
    sample = inference.make_diffusion_sample_fn(backbone, dp, tcfg.n_bits, device)
    generator = torch.Generator(device=device)

    def sample_fn(params, n: int, temperature: float, salt: int) -> torch.Tensor:
        return mesh_m.sample_rows(
            mesh, n, inference.reseed(generator, _SAMPLES, seed, salt),
            lambda rows, g: sample(params, rows, temperature, generator=g))

    return sample_fn


def calculate_bpd_with_diff_prior(backbone: NFBackbone, dp: DiffusionPrior,
                                  tcfg: DiffusionTrainConfig, params, loader: Loader,
                                  seed: int, max_batches: Optional[int] = None,
                                  with_stats: bool = False, device=None, mesh=None):
    """Variational-bound bits/dim of flow + diffusion prior over a loader
    (all of it, or its first `max_batches` batches), padded batches with the
    pad masked out; batch i draws from a generator seeded from (seed, i).
    `with_stats=True` returns (mean, images, standard error of the mean).
    With a data-parallel `mesh` each rank scores its rows of each batch with
    the global batch's draws and the per-image values are all-gathered."""
    device = resolve_device(device)
    eval_step = inference.make_vlb_eval_step(backbone, dp, tcfg.n_bits,
                                             tcfg.compat_three_channel_bpd, device)
    generator = torch.Generator(device=device)
    total, total_sq, count = 0.0, 0.0, 0
    for i, (imgs, _labels, n_valid) in enumerate(loader.padded_batches()):
        if max_batches is not None and i >= max_batches:
            break
        rows = imgs if mesh is None else imgs[mesh_m.data_sharding(mesh, len(imgs))]
        bpds = eval_step(params, rows, mesh_m.row_generator(
            mesh, inference.reseed(generator, _EVAL, seed, i), len(rows)))
        valid = mesh_m.all_gather_rows(mesh, bpds)[:n_valid].double().cpu().numpy()
        total += float(valid.sum())
        total_sq += float((valid * valid).sum())
        count += n_valid
    mean = total / max(count, 1)
    if not with_stats:
        return mean
    var = max(total_sq / max(count, 1) - mean * mean, 0.0)
    return mean, count, math.sqrt(var / max(count, 1))


def fit_latent_stats(backbone: NFBackbone, flow_params, formater, tcfg: DiffusionTrainConfig,
                     loader: Loader, *, n_batches: int = 8, seed: int = 0, device=None,
                     mesh=None):
    """Channelwise latent-standardization stats of the formater's processed
    parts, from `n_batches` batches pushed through the flow (preprocessed
    and dequantized as in training; batch i draws from (seed, i)). With a
    data-parallel `mesh` each rank pushes its rows of each batch (the
    global batch's draw, cut) and the sums are all-reduced."""
    device = resolve_device(device)
    generator = torch.Generator(device=device)

    def batches():
        for i, (imgs, _labels, n_valid) in enumerate(loader.padded_batches()):
            if i >= n_batches:
                break
            rows = slice(0, len(imgs)) if mesh is None else mesh_m.data_sharding(mesh, len(imgs))
            with torch.inference_mode():
                x = q.dequantize(mesh_m.row_generator(
                                     mesh, inference.reseed(generator, _STATS, seed, i),
                                     rows.stop - rows.start),
                                 q.preprocess(inference._on(device, imgs[rows]), tcfg.n_bits),
                                 tcfg.n_bits)
                latents, _ = backbone.transform(flow_params, x)
            keep = max(0, min(n_valid, rows.stop) - rows.start)
            yield [z[:keep] for z in latents]

    def all_reduce(sums, sumsqs, counts):
        lists = (sums, sumsqs, [np.float64(c) for c in counts])
        flat = torch.from_numpy(np.concatenate([np.ravel(a) for xs in lists for a in xs]))
        flat = mesh_m.all_reduce_sum_(mesh, flat.to(device)).cpu().numpy()
        out, offset = [], 0
        for xs in lists:
            out.append([flat[offset + sum(np.size(b) for b in xs[:k]):][:np.size(a)]
                        .reshape(np.shape(a)) for k, a in enumerate(xs)])
            offset += sum(np.size(a) for a in xs)
        sums, sumsqs, counts = out
        return sums, sumsqs, [float(c) for c in counts]

    return fit_formater_stats(formater, batches(),
                              all_reduce=None if mesh is None else all_reduce)


# -- checkpoints ----------------------------------------------------------------

def _state_from_checkpoint(tree, dp: DiffusionPrior, device):
    """A restored checkpoint (restore_state: tensors placed, parameters
    autograd leaves) with its UNets rebuilt as modules."""
    params = tree["params"]
    state = {"params": {"flow": params["flow"], "diffusion": {"parts": dp.unets_from_named(
                 params["diffusion"]["parts"], device, requires_grad=True)}},
             "opt_state": tree["opt_state"], "step": int(tree["step"])}
    if "ema" in tree:
        ema = {"diffusion": {"parts": dp.unets_from_named(tree["ema"]["diffusion"]["parts"],
                                                          device)}}
        if "flow" in tree["ema"]:
            ema["flow"] = tree["ema"]["flow"]
        state["ema"] = ema
    return state


def restore_train_state(run_dir: str, epoch: int, backbone: NFBackbone, dp: DiffusionPrior,
                        want_ema: bool, device=None) -> Dict[str, Any]:
    """The train state of a checkpoint, its EMA kept when the run wants one,
    dropped when it no longer does, seeded from the restored parameters when
    it newly does."""
    device = resolve_device(device)
    state = _state_from_checkpoint(restore_state(run_dir, "diffusion", epoch, device),
                                   dp, device)
    if not want_ema:
        state.pop("ema", None)
    elif "ema" not in state:
        state["ema"] = _ema_copy(state["params"], backbone.frozen)
    return state


def train(*, backbone: NFBackbone, flow_params, dp: DiffusionPrior,
          tcfg: DiffusionTrainConfig, loaders: DatasetLoaders, run_dir: str, logger,
          seed: int = 42, resume_dir: Optional[str] = None,
          resume_epoch: Optional[int] = None, resume_batch: Optional[int] = None,
          evaluate_fn=None, device=None, mesh=None, fsdp: bool = False) -> Dict[str, Any]:
    """The whole stage-2 training run, on `device` (CUDA unless named).
    `evaluate_fn(sample_fn, params, epoch)` is an optional hook for sample
    metrics at checkpoint epochs and, with `full=True`, at the end.

    Resume as in nf_trainer.train: `resume_epoch=E` continues after the
    complete epoch E; `resume_batch=k` re-enters the interrupted epoch E at
    batch k. Each epoch's data order being a pure function of (seed, epoch)
    and each step's draws one of (seed, step), either repeats what the
    uninterrupted run would have done. An interrupt saves the steps taken
    (EMA included) and the mid-epoch marker, then is raised again.
    `mesh` and `fsdp` as in nf_trainer.train (rank 0 writes; the interrupt's
    save meets the other ranks within `watchdog_timeout_s`)."""
    device = resolve_device(device)
    apply_matmul_precision()
    tx = make_two_group_optimizer(tcfg, backbone.frozen)
    tracker = tracker_for(run_dir, mesh)
    writer = mesh_m.is_writer(mesh)
    loss_name = dp.parts[0].cfg.loss_type + ("" if backbone.frozen else "_plus_bpd")
    want_ema = tcfg.ema_decay is not None

    start_epoch = 0
    if resume_dir is not None and resume_epoch is not None:
        state = restore_train_state(resume_dir, resume_epoch, backbone, dp, want_ema, device)
        start_epoch = resume_epoch - 1 if resume_batch is not None else resume_epoch
        logger.info(f"Resumed from {resume_dir} @ epoch {resume_epoch}"
                    + (f" batch {resume_batch}" if resume_batch is not None else ""))
    else:
        state = init_train_state(seed, backbone, flow_params, dp, tx, ema=want_ema,
                                 device=device)
    state = shard_diffusion_state(mesh, tx, state, fsdp)
    placements = diffusion_placements(mesh, tx, state["params"], fsdp)
    if mesh is not None:
        logger.info(f"Data parallel: {mesh}" + (", ZeRO moments" if placements else ""))
    current_iter = state["step"]

    train_step = make_train_step(backbone, dp, tcfg, tx, device=device, mesh=mesh, fsdp=fsdp)
    ema_fn = (make_ema_update(backbone, tcfg)
              if want_ema and tcfg.ema_update_every > 1 else None)
    sample_fn = make_sample_fn(backbone, dp, tcfg, seed, device, mesh)

    def save(epoch: int, timeout_s: Optional[float] = None) -> None:
        save_state(run_dir, "diffusion", epoch,
                   zero.whole_state(mesh, state, placements, timeout_s), mesh, timeout_s)

    def rows_of(batches):
        for imgs, labels in batches:
            yield distribute_batch(mesh, imgs), labels

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
            wd.start()  # the step loop only (nf_trainer.train)
            profiler.start_epoch(epoch)
            for batch, _labels in prefetch_to_device(rows_of(
                    loaders.train.iter_epoch(epoch - 1, start_batch=skip)), device):
                with interrupt_after_block():
                    with timer.step():
                        state, metrics = train_step(state, batch, seed)
                    current_iter += 1
                    iters_this_epoch += 1
                    if ema_fn is not None and current_iter % tcfg.ema_update_every == 0:
                        state = ema_fn(state)
                wd.beat()
                profiler.step()
                pending.append(metrics["loss"])

                if current_iter % tcfg.print_freq == 0:
                    avg = float(torch.stack(pending).mean())
                    wd.beat_sync()  # the fetch waited for the steps
                    pending = []
                    tracker.track(avg, loss_name, step=current_iter, epoch=epoch,
                                  context={"subset": "train"})
                    logger.info(f"epoch {epoch} iter {current_iter}: {loss_name} {avg:.4f}")
                    log_count += 1
                    if log_count % tcfg.log_gen_images_per_iter == 0:
                        samples = sample_fn(ema_eval_params(state), tcfg.n_samples_log,
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
                    evaluate_fn(sample_fn, ema_eval_params(state), epoch)
                save(epoch)
                samples = sample_fn(ema_eval_params(state), 64, tcfg.temperature, 2 * epoch)
                tracker.track_images(samples.cpu().numpy(), "checkpoint_samples",
                                     step=current_iter, epoch=epoch)
    except KeyboardInterrupt:
        wd.stop()
        save(epoch, tcfg.watchdog_timeout_s if mesh is not None else None)
        if writer:
            save_mid_epoch_marker(run_dir, "diffusion", epoch, iters_this_epoch)
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
    results = {}
    if evaluate_fn is not None:
        results["metrics"] = evaluate_fn(sample_fn, ema_eval_params(state), final_epoch,
                                         full=True)
    tracker.close()
    return {"state": state, "results": results, "sample_fn": sample_fn}
