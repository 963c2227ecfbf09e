"""The model axis's collectives, as autograd functions (tensor parallelism).

Counterpart of what GSPMD inserts around the JAX package's "model"-sharded
parameters (nfdpm_tpu/parallel/sharding_rules.py). The port has no
compiler to place them, so the layers that hold a parameter slab call
these explicitly (Megatron-style):

  copy_to_model    "f": identity forward, all-reduce backward. Before a
                   column-parallel layer, on its replicated input.
  reduce_from_model "g": all-reduce forward, identity backward. After a
                   row-parallel layer, on its partial output.
  scatter_to_model own slab forward, all-gather backward: a replicated
                   tensor that a rank consumes as its slab (the zeroconv's
                   input, the FiLM scale and shift of a column block).
  gather_from_model all-gather forward, own slab backward: a weight that a
                   kernel needs whole (the attention's qkv and out).

A ModelAxis is one rank's place on the axis: its size, its index and the
process group of its model group. At one model rank (None, or n = 1) every
function is the identity and no process group is touched. A collective
that fails raises naming the rank (mesh.wait_within).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class ModelAxis:
    n: int            # ranks in the model group
    index: int        # this rank's index in it
    group: Any        # the model group's process group
    rank: int = 0     # the global rank and world size, for error messages
    world: int = 1

    def __deepcopy__(self, memo):  # a module that holds it is copied (an EMA
        return self                # shadow): the process group is shared

    def per(self, size: int, what: str = "a width") -> int:
        """size // n; a size that does not divide raises."""
        if size % self.n:
            raise ValueError(f"{what} of {size} does not split over the model axis "
                             f"of {self.n}")
        return size // self.n

    def slab(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's contiguous slab of axis `dim` of `t` (a view)."""
        dim = dim % t.dim()
        per = self.per(t.shape[dim])
        return t.narrow(dim, self.index * per, per)


def active(axis: Optional[ModelAxis]) -> bool:
    return axis is not None and axis.n > 1


def _wait_within(axis: ModelAxis, work, timeout_s: Optional[float], what: str) -> None:
    from .mesh import wait_within

    wait_within(axis, work, timeout_s, f"{what} over the model group")


def _all_reduce(axis: ModelAxis, t: torch.Tensor) -> torch.Tensor:
    """The sum over the model group, in a new contiguous tensor."""
    out = t.clone(memory_format=torch.contiguous_format)
    _wait_within(axis, dist.all_reduce(out, group=axis.group, async_op=True), None,
                 "an all-reduce")
    return out


def all_gather_dim(axis: ModelAxis, t: torch.Tensor, dim: int,
                   timeout_s: Optional[float] = None) -> torch.Tensor:
    """The ranks' slabs `t` joined along `dim` in model-index order, one
    contiguous tensor (the kernels take contiguous weights; no gradient;
    waited for at most `timeout_s` seconds)."""
    dim = dim % t.dim()
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((axis.n * src.shape[0],) + tuple(src.shape[1:]))
    _wait_within(axis, dist.all_gather_into_tensor(out, src, group=axis.group, async_op=True),
                 timeout_s, "an all-gather")
    return out.movedim(0, dim).contiguous()


def p2p(axis: ModelAxis, sends: Sequence[Tuple[torch.Tensor, int]],
        recvs: Sequence[Tuple[torch.Tensor, int]]) -> None:
    """Send and receive between ranks of the model group (model indices),
    all posted together, then waited for; a received tensor is filled in
    place. gloo moves CUDA tensors through host copies (its send and recv
    take CPU tensors)."""
    staged = (dist.get_backend(axis.group) == "gloo"
              and any(t.is_cuda for t, _ in list(sends) + list(recvs)))
    wire = [(t.cpu() if staged else t, peer) for t, peer in sends]
    into = [(torch.empty_like(t, device="cpu") if staged else t, peer) for t, peer in recvs]
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(axis.group, peer), axis.group)
           for t, peer in wire]
    ops += [dist.P2POp(dist.irecv, t, dist.get_global_rank(axis.group, peer), axis.group)
            for t, peer in into]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if staged:
        for (t, _), (buf, _) in zip(recvs, into):
            t.copy_(buf)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(ctx.axis, grad), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(axis, x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.slab(x, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return all_gather_dim(ctx.axis, grad, ctx.dim), None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather_dim(axis, x, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.slab(grad, ctx.dim).contiguous(), None, None


def copy_to_model(axis: Optional[ModelAxis], x: torch.Tensor) -> torch.Tensor:
    return _CopyToModel.apply(x, axis) if active(axis) else x


def reduce_from_model(axis: Optional[ModelAxis], x: torch.Tensor) -> torch.Tensor:
    return _ReduceFromModel.apply(x, axis) if active(axis) else x


def scatter_to_model(axis: Optional[ModelAxis], x: torch.Tensor, dim: int) -> torch.Tensor:
    return _ScatterToModel.apply(x, axis, dim) if active(axis) else x


def gather_from_model(axis: Optional[ModelAxis], x: torch.Tensor, dim: int) -> torch.Tensor:
    return _GatherFromModel.apply(x, axis, dim) if active(axis) else x


def sum_over_model(axis: Optional[ModelAxis], x: torch.Tensor) -> torch.Tensor:
    """A sum of per-rank partial sums that every rank then uses with its own
    slab (weight standardization's statistics): all-reduce forward and
    backward ("g" then "f")."""
    return copy_to_model(axis, reduce_from_model(axis, x))


# -- trees of slabs ---------------------------------------------------------------

def _copy_like(t: torch.Tensor) -> torch.Tensor:
    """A dense copy of `t` (4-D conv weights in channels-last memory, as
    convert.tree_to_device keeps them), an autograd leaf when `t` was one."""
    fmt = torch.channels_last if t.dim() == 4 else torch.contiguous_format
    out = t.detach().clone(memory_format=fmt)
    return out.requires_grad_(t.requires_grad)


def shard_tree(axis: Optional[ModelAxis], tree: Any, placements, prefix: str = "") -> Any:
    """`tree` with each tensor at a path of `placements`
    (sharding_rules.Placement over the model axis) replaced by this rank's
    slab as a tensor of its own, and each UNet module narrowed in place
    (models/unet.shard_unet_, by the same rules); the rest as it is."""
    if not active(axis) or not placements:
        return tree
    if isinstance(tree, torch.nn.Module):
        from ..models.unet import shard_unet_

        return shard_unet_(tree, axis)
    if isinstance(tree, dict):
        return {k: shard_tree(axis, v, placements, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [shard_tree(axis, v, placements, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    if isinstance(tree, torch.Tensor) and prefix in placements:
        return _copy_like(placements[prefix].slab(tree, axis.index))
    return tree


def gather_leaves(axis: Optional[ModelAxis], tree: Any, placements, prefix: str = "",
                  timeout_s: Optional[float] = None) -> Any:
    """`tree` with every placed leaf made whole from the model group's slabs
    (one all-gather a leaf, no gradient; a module comes back as the dict of
    its parameters by name, what a checkpoint holds). A collective over the
    model group: its ranks call it together."""
    from ..convert import named_leaves
    from .sharding_rules import replace_leaves

    if not active(axis) or not placements:
        return tree
    new = {p: all_gather_dim(axis, t.detach(), placements[p].dim, timeout_s)
           for p, t in named_leaves(tree, prefix) if p in placements}
    return replace_leaves(tree, new, prefix)


_STATE_TREES = ("params", "ema")


def shard_state(axis: Optional[ModelAxis], state: Dict[str, Any], placements) -> Dict[str, Any]:
    """A whole train state (parameters, Adam moments, EMA shadow) cut to
    this rank's model slabs (shard_tree); the step and the count kept."""
    if not active(axis) or not placements:
        return state
    out = {k: shard_tree(axis, v, placements) if k in _STATE_TREES else v
           for k, v in state.items()}
    opt = state["opt_state"]
    out["opt_state"] = {**opt, "mu": shard_tree(axis, opt["mu"], placements),
                        "nu": shard_tree(axis, opt["nu"], placements)}
    return out


def whole_state(axis: Optional[ModelAxis], state: Dict[str, Any], placements,
                timeout_s: Optional[float] = None) -> Dict[str, Any]:
    """The state with every model slab made whole (gather_leaves): what a
    checkpoint holds, the one-device layout. A collective over the model
    group, each gather waited for at most `timeout_s` seconds."""
    if not active(axis) or not placements:
        return state
    out = {k: gather_leaves(axis, v, placements, timeout_s=timeout_s)
           if k in _STATE_TREES else v for k, v in state.items()}
    opt = state["opt_state"]
    out["opt_state"] = {**opt, "mu": gather_leaves(axis, opt["mu"], placements,
                                                   timeout_s=timeout_s),
                        "nu": gather_leaves(axis, opt["nu"], placements, timeout_s=timeout_s)}
    return out
