"""Pipeline parallelism of the Glow train step: the K flow steps over stages.

Counterpart of nfdpm_tpu/parallel/pipeline.py, with its names. The model
axis becomes a pipeline axis: stage s (model index s) holds steps
[s K/S, (s+1) K/S) of every level's K steps and of the final steps
(`glow_pp_placements`, owner placements: the port keeps the K steps as
separate leaves, so a stage holds whole steps and the others none), so a
stage's flow parameters and Adam moments are about 1/S of the flow's. The
split priors and the Gaussian prior stay whole on every stage. A stage's
steps run at the full coupling width, on the port's usual route: the CUDA
kernels on the card, the plain route on the CPU.

Schedule (`pp_forward`): GPipe over M microbatches. Each level's squeeze
runs on every stage; then M + S - 1 ticks, in each of which stage 0 takes
in microbatch t, a stage that holds a microbatch runs its local steps on it,
and the activation with its running logdet passes one stage on (a hop:
batch_isend_irecv to the next stage, from the previous one). The last
stage's retired outputs are broadcast to the model group (the flush), and
the split runs on every stage. The bubble is (S-1)/(M+S-1). Levels are
flushes, because squeeze and split change the activation's shape between
them.

The backward runs the same way back: a hop's backward carries the
cotangent one stage back, the flush's gives the last stage the cotangent of
the outputs. Every stage computes the same loss from the flushed values,
and only stage 0 takes the flushed values into the next level's pipeline,
so stage 0 holds their whole cotangent: the flush's backward broadcasts it
from stage 0 (summing the stages' cotangents would count the shared part S
times). One scalar link threads every hop and flush of a stage in order,
so that each stage runs them all, in reverse order, in its backward, and
the sends and receives of the stages pair up; no rank blocks on an order
autograd chooses.

Each data index runs its own pipeline over its model group. Evaluation,
the samplers and checkpoints gather the whole flow from the stages'
owners (parallel/zero.py) and run the plain forward.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..convert import named_leaves
from ..models import glow as glow_m
from ..ops import bijectors as bj
from .mesh import _flat
from .sharding_rules import Placement
from .tensor_parallel import p2p

Params = Any


def glow_pp_placements(flow: Params, n_stages: int, prefix: str = "flow"
                       ) -> Dict[str, Placement]:
    """Every leaf of step k of a level's K steps (and of the final steps) on
    stage k // (K / S): `Placement(owner=...)` over the model axis; the split
    priors not placed (whole on every stage). Adam's moments follow."""
    out: Dict[str, Placement] = {}

    def stack(steps, path):
        per = len(steps) // n_stages
        for k, step in enumerate(steps):
            for leaf_path, _ in named_leaves(step, f"{path}/{k}"):
                out[leaf_path] = Placement(n_stages, owner=k // per)

    for b, block in enumerate(flow["blocks"]):
        stack(block["steps"], f"{prefix}/blocks/{b}/steps")
    stack(flow["final_steps"], f"{prefix}/final_steps")
    return out


def check_pipeline_config(cfg: glow_m.GlowConfig, n_stages: int, microbatches: int,
                          local_batch: Optional[int] = None) -> None:
    """The JAX package's divisibility guards, with its messages (its
    `use_pallas` guard is the entry point's here: the port's kernels run
    inside a stage). `local_batch` None: the batch is not checked (before a
    launch, which the data axis's size needs)."""
    if cfg.steps % n_stages:
        raise ValueError(
            f"pipeline parallelism needs K ({cfg.steps}) divisible by the "
            f"model-axis size ({n_stages}) — each stage holds K/S steps")
    if microbatches < 1:
        raise ValueError(f"pipeline_microbatches must be >= 1, got {microbatches}")
    if local_batch is not None and local_batch % microbatches:
        raise ValueError(
            f"per-data-shard batch ({local_batch}) must be divisible by "
            f"pipeline_microbatches ({microbatches})")


def check_exclusive(pipeline: bool, fsdp: bool = False, spatial: bool = False) -> None:
    """The JAX package's refusals of two layouts of the flow at once."""
    if pipeline and spatial:
        raise ValueError("pipeline and spatial partitioning both use the "
                         "\"model\" axis — enable at most one")
    if pipeline and fsdp:
        raise ValueError("pipeline + fsdp both repartition the flow "
                         "params — enable at most one")


# -- the hops and the flush ---------------------------------------------------------

def _p2p(axis, sends: Sequence[Tuple[torch.Tensor, int]],
         recvs: Sequence[Tuple[torch.Tensor, int]]) -> None:
    """Send and receive between stages of the model group (stage indices),
    all posted together, then waited for (tensor_parallel.p2p)."""
    p2p(axis, sends, recvs)


def _bcast(axis, buf: torch.Tensor, stage: int) -> None:
    """Broadcast `buf` from `stage` to the model group, in place."""
    dist.broadcast(buf, src=dist.get_global_rank(axis.group, stage), group=axis.group)


def _unflat(flat: torch.Tensor, like: Sequence[torch.Size]) -> List[torch.Tensor]:
    out, offset = [], 0
    for shape in like:
        n = int(torch.Size(shape).numel())
        out.append(flat[offset:offset + n].view(shape))
        offset += n
    return out


class _Hop(torch.autograd.Function):
    """Stage s sends (act, logdet) to stage s+1 (`send`) and receives the
    pair of stage s-1 (`recv`, shaped `shapes`). Backward: the received
    pair's cotangent goes back to stage s-1, the sent pair's comes from
    stage s+1. `link` passes through, ordering the stage's hops."""

    @staticmethod
    def forward(ctx, axis, shapes, send, recv, link, *sent):
        ctx.axis, ctx.shapes, ctx.send, ctx.recv = axis, shapes, send, recv
        s = axis.index
        buf = link.new_empty(sum(int(torch.Size(sh).numel()) for sh in shapes)) if recv else None
        _p2p(axis, [(_flat(sent), s + 1)] if send else [], [(buf, s - 1)] if recv else [])
        received = tuple(_unflat(buf, shapes)) if recv else ()
        return (link.clone(),) + received

    @staticmethod
    def backward(ctx, g_link, *g_received):
        axis, s = ctx.axis, ctx.axis.index
        g_sent = None
        if ctx.send:
            g_sent = g_link.new_empty(sum(int(torch.Size(sh).numel()) for sh in ctx.shapes))
        back = []
        if ctx.recv:
            back = [(_flat([g if g is not None else g_link.new_zeros(sh)
                            for g, sh in zip(g_received, ctx.shapes)]), s - 1)]
        _p2p(axis, back, [(g_sent, s + 1)] if ctx.send else [])
        grads = tuple(_unflat(g_sent, ctx.shapes)) if ctx.send else ()
        return (None, None, None, None, g_link) + grads


class _Flush(torch.autograd.Function):
    """The last stage's retired (act, logdet) broadcast to the model group.
    Backward: stage 0's cotangent (the whole one, see the module docstring)
    broadcast, and taken by the last stage only."""

    @staticmethod
    def forward(ctx, axis, shapes, link, *outs):
        ctx.axis, ctx.shapes = axis, shapes
        last = axis.n - 1
        if axis.index == last:
            buf = _flat(outs)
        else:
            buf = link.new_empty(sum(int(torch.Size(sh).numel()) for sh in shapes))
        _bcast(axis, buf, last)
        return (link.clone(),) + tuple(_unflat(buf, shapes))

    @staticmethod
    def backward(ctx, g_link, *g_outs):
        axis = ctx.axis
        if axis.index == 0:
            buf = _flat([g if g is not None else g_link.new_zeros(sh)
                         for g, sh in zip(g_outs, ctx.shapes)])
        else:
            buf = g_link.new_empty(sum(int(torch.Size(sh).numel()) for sh in ctx.shapes))
        _bcast(axis, buf, 0)
        grads = tuple(_unflat(buf, ctx.shapes)) if axis.index == axis.n - 1 else ()
        return (None, None, g_link) + grads


# -- the schedule -----------------------------------------------------------------

def _pp_level(steps: Sequence[Params], y: torch.Tensor, ldj: torch.Tensor,
              link: Optional[torch.Tensor], cfg: glow_m.GlowConfig, axis,
              microbatches: int):
    """One level's K steps pipelined over the stages (GPipe). `y`, `ldj`:
    the level's whole input, the same on every stage. Returns the level's
    output and logdet, the same on every stage, and the link."""
    n, s = (1, 0) if axis is None else (axis.n, axis.index)
    per = len(steps) // n
    local = steps[s * per:(s + 1) * per]
    ys, ls = y.chunk(microbatches), ldj.chunk(microbatches)
    shapes = (tuple(ys[0].shape), tuple(ls[0].shape))
    out_y, out_l = [], []
    act = acc = None
    for t in range(microbatches + n - 1):
        if s == 0 and t < microbatches:
            act, acc = ys[t], ls[t]
        active = 0 <= t - s < microbatches
        if active:
            for sp in local:
                act, acc = glow_m.run_step(sp, act, acc, cfg)
            if s == n - 1:
                out_y.append(act)
                out_l.append(acc)
        send = active and s < n - 1
        recv = s > 0 and 0 <= t - (s - 1) < microbatches
        if send or recv:
            link, *received = _Hop.apply(axis, shapes, send, recv, link,
                                         *((act, acc) if send else ()))
            if recv:
                act, acc = received
    if n == 1:
        return torch.cat(out_y), torch.cat(out_l), link
    whole = (tuple(y.shape), tuple(ldj.shape))
    outs = (torch.cat(out_y), torch.cat(out_l)) if s == n - 1 else ()
    link, y, ldj = _Flush.apply(axis, whole, link, *outs)
    return y, ldj, link


def pp_forward(flow_params: Params, cfg: glow_m.GlowConfig, x: torch.Tensor, mesh,
               microbatches: int, with_logp: bool = True):
    """Drop-in for models.glow.forward on the ranks of one model group, with
    each level's K steps pipelined over the mesh's model axis
    (`flow_params`: this stage's, steps of other stages empty). Composes
    with the data axis: each data index runs its own pipeline over the same
    stages. Returns (latent parts, ldj [B], logp [B] or None), the same on
    every stage."""
    axis = mesh.model
    b = x.shape[0]
    ldj = torch.zeros((b,), dtype=torch.float32, device=x.device)
    logp = torch.zeros((b,), dtype=torch.float32, device=x.device) if with_logp else None
    link = None if axis is None else torch.zeros((), device=x.device,
                                                 requires_grad=torch.is_grad_enabled())
    latents = []
    y = x
    for block in flow_params["blocks"]:
        y = bj.squeeze_forward(y)
        y, ldj, link = _pp_level(block["steps"], y, ldj, link, cfg, axis, microbatches)
        y, ldj, z, logp = bj.split_forward(block["split"], y, ldj, logp)
        latents.append(z)
    y = bj.squeeze_forward(y)
    y, ldj, _ = _pp_level(flow_params["final_steps"], y, ldj, link, cfg, axis, microbatches)
    latents.append(y)
    return latents, ldj, logp
