"""Optimizer: adam/adamw behind the flow trainer's double gradient clipping,
and the diffusion trainer's two learning-rate groups without clipping.

Counterpart of nfdpm_tpu/training/optim.py, which chains optax transforms:

    clip by value 1 -> clip by global norm 1 -> adam | adamw

over the trainable leaves only: the PLU constants p_mat and sign never
update, and with `fixed_prior=True` neither do the final Gaussian prior's
leaves; what never updates does not enter the global norm either. Written
out here to match optax, not torch.optim:

  * the norm clip leaves g alone when norm < max and else gives
    g / norm * max (torch's clip_grad_norm_ divides by norm + 1e-6);
  * adamw's weight decay is optax's default 1e-4 (torch's is 1e-2), added to
    the Adam direction before the learning rate scales both;
  * the learning rate is a schedule of the optimizer's own step count, which
    is part of the state, so a resumed run continues the schedule.

Each top level of the tree is a group with its own schedule, or None for
a group that never updates (optax.set_to_zero): {"flow", "prior"} for the
flow trainer (make_optimizer), {"diffusion", "flow"} without clipping for
the diffusion trainer (its make_two_group_optimizer).

State: {"mu": tree, "nu": tree, "count": int}, the moments shaped like the
parameter tree (zeros where a leaf never updates; a module's parameters
become a dict by name). `apply` updates the parameters and the moments in
place and makes no host synchronisation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..convert import is_frozen_path, map_tree, named_leaves
from ..utils.profiling import annotate

Tree = Any
Schedule = Callable[[int], float]


def make_lr_schedule(lr: float, schedule: str = "constant", warmup_steps: int = 0,
                     decay_steps: Optional[int] = None,
                     end_lr_factor: float = 0.0) -> Schedule:
    """step count -> learning rate.

      * "constant": `lr`, after an optional linear warmup from 0 over
        `warmup_steps` (so the first update of a warmed-up run is zero).
      * "cosine": that warmup, then a cosine decay to `lr * end_lr_factor`
        at `decay_steps` (total steps including the warmup), held after."""
    if schedule not in ("constant", "cosine"):
        raise ValueError(f"Unknown lr schedule: {schedule!r} "
                         "(one of 'constant', 'cosine')")
    if schedule == "cosine" and decay_steps is None:
        raise ValueError("cosine schedule needs decay_steps "
                         "(total steps including warmup)")

    def warmup(count: int) -> float:
        return lr * min(count, warmup_steps) / warmup_steps

    if schedule == "constant":
        return warmup if warmup_steps > 0 else (lambda count: lr)

    span = max(decay_steps - warmup_steps, 1)
    alpha = end_lr_factor if lr != 0.0 else 0.0

    def cosine(count: int) -> float:
        if count < warmup_steps:
            return warmup(count)
        frac = min(count - warmup_steps, span) / span
        return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)

    return cosine


@dataclasses.dataclass(frozen=True)
class Optimizer:
    # top-level key of the tree -> its schedule; None, or a key not named,
    # for a group that never updates
    groups: Dict[str, Optional[Schedule]]
    name: str = "adam"
    clip_value: Optional[float] = 1.0
    clip_norm: Optional[float] = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4  # adamw only

    def schedule_of(self, path: str) -> Optional[Schedule]:
        """The schedule of the leaf at `path`, None where it is never updated."""
        if is_frozen_path(path):
            return None
        return self.groups.get(path.split("/", 1)[0])

    def updates(self, path: str) -> bool:
        """Whether the leaf at `path` ("flow/...", "prior/...") is updated."""
        return self.schedule_of(path) is not None

    def init(self, params: Tree) -> Dict[str, Any]:
        return {"mu": map_tree(params, torch.zeros_like),
                "nu": map_tree(params, torch.zeros_like), "count": 0}

    def clipped(self, grads: List[torch.Tensor], n_shards: int = 0, mesh=None,
                model_sharded: Optional[Sequence[bool]] = None) -> List[torch.Tensor]:
        """The gradients after both clips, as new tensors. Under ZeRO the
        first `n_shards` are this rank's slabs of partitioned leaves and the
        rest replicated leaves (equal on every rank): the global norm sums
        the slabs' squares over the ranks with ONE all-reduce and adds each
        replicated leaf once. Under a model axis `model_sharded[i]` says
        whether grads[i] is a model slab: its squares are summed over the
        model group too (ONE more all-reduce), a leaf replicated over the
        model axis counted once."""
        if self.clip_value is not None:
            grads = torch._foreach_clamp_min(grads, -self.clip_value)
            grads = torch._foreach_clamp_max(grads, self.clip_value)
        if self.clip_norm is not None:
            if model_sharded is not None and any(model_sharded):
                norm = _model_axis_norm(grads, n_shards, mesh, model_sharded)
            elif n_shards:
                from ..parallel.mesh import all_reduce_sum_

                def sum_sq(ts):
                    return (torch.stack(torch._foreach_norm(ts)).square().sum() if ts
                            else grads[0].new_zeros(()))

                norm = torch.sqrt(all_reduce_sum_(mesh, sum_sq(grads[:n_shards]))
                                  + sum_sq(grads[n_shards:]))
            else:
                norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            denom = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                                norm / self.clip_norm)
            grads = torch._foreach_div(grads, denom)
        return grads

    @torch.no_grad()
    @annotate("optim.apply")
    def apply(self, params: Tree, grads: Tree, state: Dict[str, Any], mesh=None,
              placements: Optional[Dict[str, Any]] = None,
              extras: Sequence[torch.Tensor] = (),
              model_placements: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """One update, in place: `params`' leaves and the moments in `state`
        change, and the returned state is `state` with its count raised.
        `grads` has `params`' structure; a leaf that is updated needs its
        gradient.

        With a data-parallel `mesh` (parallel/mesh.py) the gradients are each
        rank's; those of the leaves held whole are averaged over the ranks
        with the scalars `extras` (a step's metrics, averaged in place)
        through ONE all-reduce over a flat buffer of the data group. A leaf
        that `placements` (the data axis's, parallel/zero.py) partitions is
        held as this rank's slab, parameter and moments alike, and its
        gradient is already the slab of the data ranks' mean (the backward of
        its gather on use): Adam updates the slab and nothing more moves.
        Under a model axis the leaves that `model_placements` names are the
        rank's slabs, or under the pipeline a stage's whole steps (moments
        alike): Adam and the value clip are local, the norm clip's squares
        summed over the model group (clipped). The span optim.apply holds
        the whole update, optim.grad_allreduce inside it the data group's
        all-reduce."""
        from ..parallel import mesh as mesh_m

        placements = placements or {}
        model_placements = model_placements or {}
        rows = []
        for (path, p), (_, g), (_, m), (_, v) in zip(
                *(named_leaves(t, keep_none=True)
                  for t in (params, grads, state["mu"], state["nu"]))):
            schedule = None if p is None else self.schedule_of(path)
            if schedule is not None:
                if g is None:
                    raise ValueError(f"no gradient for the trainable leaf {path}")
                rows.append((p, g, m, v, schedule, path in placements,
                             path in model_placements))
        if mesh is not None and mesh.data_group is not None:
            with annotate("optim.grad_allreduce"):
                mesh_m.all_reduce_mean_(mesh, [r[1] for r in rows if not r[5]] + list(extras))
        if not rows:
            return dict(state, count=state["count"] + 1)
        # the slabs first: the norm clip sums their squares over the ranks
        rows = [r for r in rows if r[5]] + [r for r in rows if not r[5]]
        ps, gs, mus, nus, schedules, placed, model_sharded = (list(col) for col in zip(*rows))
        gs = self.clipped(gs, sum(placed), mesh, model_sharded)

        count = state["count"] + 1
        torch._foreach_mul_(mus, self.b1)
        torch._foreach_add_(mus, gs, alpha=1.0 - self.b1)
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_addcmul_(nus, gs, gs, value=1.0 - self.b2)
        denom = torch._foreach_div(nus, 1.0 - self.b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(mus, 1.0 - self.b1 ** count)
        torch._foreach_div_(step, denom)
        if self.name == "adamw":
            torch._foreach_add_(step, ps, alpha=self.weight_decay)
        # the rate of this update is the schedule at the count before it;
        # one foreach add per group
        for schedule in dict.fromkeys(schedules):
            group = [i for i, s in enumerate(schedules) if s is schedule]
            torch._foreach_add_([ps[i] for i in group], [step[i] for i in group],
                                alpha=-schedule(count - 1))
        return dict(state, count=count)


def _model_axis_norm(grads: List[torch.Tensor], n_shards: int, mesh,
                     model_sharded: Sequence[bool]) -> torch.Tensor:
    """The global norm of gradients of which the first `n_shards` are ZeRO
    slabs over the data axis and those `model_sharded` flags are slabs over
    the model axis: each class's squares summed, the model slabs' over the
    model group, then the data slabs' over the data group (two all-reduces
    of a few scalars), each replicated leaf counted once."""
    from ..parallel import tensor_parallel as tp
    from ..parallel.mesh import all_reduce_sum_

    def sum_sq(keep):
        ts = [g for i, g in enumerate(grads) if keep(i < n_shards, model_sharded[i])]
        return (torch.stack(torch._foreach_norm(ts)).square().sum() if ts
                else grads[0].new_zeros(()))

    both, model_only = sum_sq(lambda d, m: d and m), sum_sq(lambda d, m: m and not d)
    data_only, neither = sum_sq(lambda d, m: d and not m), sum_sq(lambda d, m: not (d or m))
    over_model = tp._all_reduce(mesh.model, torch.stack([both, model_only]))
    over_data = torch.stack([over_model[0], data_only])
    if n_shards:
        all_reduce_sum_(mesh, over_data)
    return torch.sqrt(over_data[0] + over_model[1] + over_data[1] + neither)


def grads_of(params: Tree) -> Tree:
    """The tree of the leaves' accumulated `.grad`s (None where there is none);
    a module's become a dict by parameter name."""
    return map_tree(params, lambda p: p.grad)


def make_optimizer(name: str = "adam", lr: float = 1e-3,
                   clip_value: Optional[float] = 1.0, clip_norm: Optional[float] = 1.0,
                   fixed_prior: bool = False,
                   lr_schedule: Optional[Schedule] = None) -> Optimizer:
    """`fixed_prior=True` keeps the final Gaussian prior at its init and out
    of the norm clip, as the flow trainer's default does; False trains it
    too. `lr_schedule` (make_lr_schedule) takes the place of the flat `lr`."""
    if name not in ("adam", "adamw"):
        raise ValueError(f"Unknown optimizer: {name}")
    schedule = lr_schedule if lr_schedule is not None else (lambda count: lr)
    return Optimizer(groups={"flow": schedule, "prior": None if fixed_prior else schedule},
                     name=name, clip_value=clip_value, clip_norm=clip_norm)
