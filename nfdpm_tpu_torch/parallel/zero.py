"""A train state partitioned over one axis of the mesh, and the gathers that
make it whole again: ZeRO stage 3 (fully sharded data parallelism) over the
data axis, and the pipeline's stages over the model axis.

Counterpart of what GSPMD does with the JAX package's "data"-sharded
parameters (nfdpm_tpu/parallel/sharding_rules.py `_add_fsdp`) and its
K-axis "model" specs (nfdpm_tpu/parallel/pipeline.py). A `Layout` records,
for every placed leaf (a path of convert.named_leaves of the parameter
tree), its sharding_rules.Placement over the axis and its shape before the
cut. `shard_state` cuts the parameters, Adam's moments and the EMA shadow
alike to this rank's part (a slab of an axis, or a whole leaf on its
owner and an empty one elsewhere) and keeps the layout in the state under
"layout"; `whole_state` gathers them back, which checkpoints, evaluation and
the samplers read.

Gather on use (the data axis, `parallel.fsdp`): a unit of the model (a Glow
step, the split prior of a level, a UNet block, the rest of a UNet, the
Gaussian prior) calls `Layout.gather` just before it runs. The slabs of its
leaves come back whole through ONE all_gather_into_tensor over the data
group (and a broadcast from the owner for a whole leaf one rank holds),
contiguous, as the kernels take them (4-D conv weights in channels-last
memory, as the port keeps them). The backward is a reduce-scatter: the
gradient of each slab is this rank's slab of the data ranks' mean gradient
(the owner's sum for an owned leaf), so the optimizer updates the
slabs with nothing more to average. The whole tensors are not kept past the
step: under `GlowConfig.remat` the gather runs inside the recomputed step,
so the backward gathers again and the forward frees them at once; without
it autograd keeps a unit's gathered weights until the backward of that unit
has run, as it keeps its activations. Between steps a rank holds its
slabs only (sharding_rules.predicted_param_bytes). Under grad_accum each
microbatch's forward gathers its units again and its backward
reduce-scatters them.

A leaf that is not placed (smaller than FSDP_MIN_SIZE, or with no axis that
divides) is whole on every rank; its gradient is averaged by the
optimizer's all-reduce (training/optim.py).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..convert import named_leaves
from .mesh import wait_within
from .sharding_rules import Placement, replace_leaves


def _join(prefix: str, path: str) -> str:
    return f"{prefix}/{path}" if prefix and path else prefix or path


@dataclasses.dataclass(frozen=True, eq=False)
class Layout:
    """How a rank holds a state partitioned over the mesh's `axis` ("data"
    or "model"): each placed leaf's placement and its shape before the cut.
    `prefix` roots the paths a model's unit names (`at`)."""
    mesh: Any
    axis: str
    placements: Dict[str, Placement]
    shapes: Dict[str, Tuple[int, ...]]
    prefix: str = ""

    def __deepcopy__(self, memo):  # a module that holds it is copied (an EMA
        return self                # shadow): the process group is shared

    @property
    def group(self):
        return self.mesh.data_group if self.axis == "data" else self.mesh.model_group

    @property
    def index(self) -> int:
        return self.mesh.data_rank if self.axis == "data" else self.mesh.model_rank

    @property
    def n(self) -> int:
        return self.mesh.data_world if self.axis == "data" else self.mesh.n_model

    def at(self, prefix: str) -> "Layout":
        """The layout with unit paths taken under `prefix` ("flow", a UNet's
        "diffusion/parts/<i>")."""
        return dataclasses.replace(self, prefix=_join(self.prefix, prefix))

    def gather(self, tree: Any, path: str = "") -> Any:
        """`tree` (the unit at `path`) with each placed leaf made whole, with
        a gradient: the reduce-scatter of gather_on_use's backward."""
        full = _join(self.prefix, path)
        placed = [(p, t) for p, t in named_leaves(tree, full) if p in self.placements]
        if not placed:
            return tree
        paths = tuple(p for p, _ in placed)
        wholes = _GatherOnUse.apply(self, paths, *(t for _, t in placed))
        return replace_leaves(tree, dict(zip(paths, wholes)), full)

    @contextlib.contextmanager
    def swapped(self, module: torch.nn.Module, path: str, names: Sequence[str]):
        """Inside the block, `module`'s parameters `names` are their whole
        tensors, gathered with a gradient; the slabs are back in place after
        it. `path`: the module's dotted name in the module the layout is
        rooted at ("" for that module itself)."""
        full = {n: _join(self.prefix, f"{path}.{n}" if path else n) for n in names}
        placed = [n for n in names if full[n] in self.placements]
        if not placed:
            yield
            return
        params = dict(module.named_parameters())
        wholes = _GatherOnUse.apply(self, tuple(full[n] for n in placed),
                                    *(params[n] for n in placed))
        swaps = []
        for name, whole in zip(placed, wholes):
            owner_name, _, leaf = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            swaps.append((owner, leaf, owner._parameters[leaf]))
            owner._parameters[leaf] = whole
        try:
            yield
        finally:
            for owner, leaf, slab in swaps:
                owner._parameters[leaf] = slab


# -- the collectives --------------------------------------------------------------

def _numel(shape) -> int:
    return math.prod(shape)


def _whole_like(shape, like: torch.Tensor) -> torch.Tensor:
    fmt = torch.channels_last if len(shape) == 4 else torch.contiguous_format
    return torch.empty(shape, dtype=like.dtype, device=like.device, memory_format=fmt)


def _owner_rank(layout: Layout, owner: int) -> int:
    return dist.get_global_rank(layout.group, owner)


def _gather(layout: Layout, paths: Sequence[str], slabs: Sequence[torch.Tensor],
            timeout_s: Optional[float] = None) -> List[torch.Tensor]:
    """The whole tensors of the placed leaves `paths` from every rank's
    `slabs`: the slabs of an axis through one all-gather, the leaves of each
    owner through one broadcast (each waited for at most `timeout_s` s)."""
    pls = [layout.placements[p] for p in paths]
    out: List[Optional[torch.Tensor]] = [None] * len(paths)
    dims = [i for i, pl in enumerate(pls) if pl.dim is not None]
    if dims:
        mine = torch.cat([slabs[i].detach().reshape(-1) for i in dims])
        buf = mine.new_empty(layout.n * mine.numel())
        work = dist.all_gather_into_tensor(buf, mine, group=layout.group, async_op=True)
        wait_within(layout.mesh, work, timeout_s, f"the all-gather of the {layout.axis} slabs")
        seg, offset = mine.numel(), 0
        for i in dims:
            shape, pl = layout.shapes[paths[i]], pls[i]
            whole = _whole_like(shape, mine)
            per = shape[pl.dim] // layout.n
            size = slabs[i].numel()
            for r in range(layout.n):
                piece = buf[r * seg + offset:r * seg + offset + size]
                whole.narrow(pl.dim, r * per, per).copy_(piece.view(slabs[i].shape))
            offset += size
            out[i] = whole
    for owner in sorted({pl.owner for pl in pls if pl.dim is None}):
        idx = [i for i, pl in enumerate(pls) if pl.dim is None and pl.owner == owner]
        like = slabs[idx[0]]
        if layout.index == owner:
            buf = torch.cat([slabs[i].detach().reshape(-1) for i in idx])
        else:
            buf = like.new_empty(sum(_numel(layout.shapes[paths[i]]) for i in idx))
        work = dist.broadcast(buf, src=_owner_rank(layout, owner), group=layout.group,
                              async_op=True)
        wait_within(layout.mesh, work, timeout_s, f"the broadcast of rank {owner}'s leaves")
        offset = 0
        for i in idx:
            shape = layout.shapes[paths[i]]
            whole = buf[offset:offset + _numel(shape)].view(shape)
            out[i] = whole.contiguous(memory_format=torch.channels_last) if len(shape) == 4 \
                else whole
            offset += _numel(shape)
    return out


def _reduce_scatter_mean(layout: Layout, paths: Sequence[str],
                         slab_shapes: Sequence[torch.Size],
                         grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each slab's part of the data ranks' mean of the whole gradients
    `grads`: one reduce-scatter for the slabs of an axis, one all-reduce
    for each owner's leaves, which the owner keeps (an empty gradient on
    the other ranks)."""
    pls = [layout.placements[p] for p in paths]
    out: List[Optional[torch.Tensor]] = [None] * len(paths)
    dims = [i for i, pl in enumerate(pls) if pl.dim is not None]
    n = layout.n
    if dims:
        parts = []
        for r in range(n):
            for i in dims:
                per = grads[i].shape[pls[i].dim] // n
                parts.append(grads[i].narrow(pls[i].dim, r * per, per).reshape(-1))
        flat = torch.cat(parts)
        mine = flat.new_empty(flat.numel() // n)
        dist.reduce_scatter_tensor(mine, flat, group=layout.group)
        mine.div_(n)
        offset = 0
        for i in dims:
            size = _numel(slab_shapes[i])
            out[i] = mine[offset:offset + size].view(slab_shapes[i])
            offset += size
    for owner in sorted({pl.owner for pl in pls if pl.dim is None}):
        idx = [i for i, pl in enumerate(pls) if pl.dim is None and pl.owner == owner]
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=layout.group)  # gloo has no reduce of CUDA tensors
        offset = 0
        for i in idx:
            if layout.index == owner:
                size = _numel(slab_shapes[i])
                out[i] = flat[offset:offset + size].view(slab_shapes[i]).div_(n)
                offset += size
            else:
                out[i] = grads[i].new_zeros(slab_shapes[i])
    return out


class _GatherOnUse(torch.autograd.Function):
    """slabs -> whole tensors (all-gather, broadcast from an owner); the
    backward: the mean gradient's slabs (reduce-scatter; an all-reduce
    that an owner keeps). Every data rank runs the same units in the same order, forward
    and backward, so the collectives pair up."""

    @staticmethod
    def forward(ctx, layout, paths, *slabs):
        ctx.layout, ctx.paths = layout, paths
        ctx.slab_shapes = [s.shape for s in slabs]
        ctx.like = slabs[0].new_empty(())
        return tuple(_gather(layout, paths, slabs))

    @staticmethod
    def backward(ctx, *grads):
        if not any(ctx.needs_input_grad[2:]):
            return (None, None) + (None,) * len(grads)
        grads = [ctx.like.new_zeros(ctx.layout.shapes[p]) if g is None else g
                 for g, p in zip(grads, ctx.paths)]
        slabs = _reduce_scatter_mean(ctx.layout, ctx.paths, ctx.slab_shapes, grads)
        return (None, None) + tuple(s if need else None
                                    for s, need in zip(slabs, ctx.needs_input_grad[2:]))


# -- states -------------------------------------------------------------------------

_TREES = ("params", "ema")


def _copy_slab(t: torch.Tensor, pl: Placement, index: int) -> torch.Tensor:
    """This rank's part of `t` as a tensor of its own (channels-last for a
    4-D conv weight), an autograd leaf when `t` was one."""
    fmt = torch.channels_last if t.dim() == 4 else torch.contiguous_format
    out = pl.slab(t.detach(), index).clone(memory_format=fmt)
    return out.requires_grad_(t.requires_grad)


def _cut(layout: Layout, tree: Any, prefix: str = "") -> Any:
    """`tree` with every placed leaf cut to this rank's part; a module's
    parameters are replaced in place."""
    if isinstance(tree, torch.nn.Module):
        modules = dict(tree.named_modules())
        for name, p in list(tree.named_parameters()):
            path = _join(prefix, name)
            if path in layout.placements:
                owner, _, leaf = name.rpartition(".")
                slab = _copy_slab(p, layout.placements[path], layout.index)
                setattr(modules[owner], leaf, torch.nn.Parameter(slab,
                                                                 requires_grad=p.requires_grad))
        return tree
    if isinstance(tree, dict):
        return {k: _cut(layout, v, _join(prefix, str(k))) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cut(layout, v, _join(prefix, str(i))) for i, v in enumerate(tree)]
    if isinstance(tree, torch.Tensor) and prefix in layout.placements:
        return _copy_slab(tree, layout.placements[prefix], layout.index)
    return tree


def _whole(layout: Layout, tree: Any, timeout_s: Optional[float] = None) -> Any:
    """A copy of `tree` with every placed leaf whole (no gradient; a module
    comes back as a new module whose units no longer gather)."""
    placed = [(p, t) for p, t in named_leaves(tree) if p in layout.placements]
    if not placed:
        return tree
    with torch.no_grad():
        wholes = dict(zip((p for p, _ in placed),
                          _gather(layout, [p for p, _ in placed], [t for _, t in placed],
                                  timeout_s)))

    def rebuild(node, prefix):
        if isinstance(node, torch.nn.Module):
            module = copy.deepcopy(node)
            modules = dict(module.named_modules())
            for name, p in list(module.named_parameters()):
                if _join(prefix, name) in wholes:
                    owner, _, leaf = name.rpartition(".")
                    setattr(modules[owner], leaf, torch.nn.Parameter(
                        wholes[_join(prefix, name)], requires_grad=False))
            if hasattr(module, "fsdp"):
                module.fsdp = None
            return module
        if isinstance(node, dict):
            return {k: rebuild(v, _join(prefix, str(k))) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rebuild(v, _join(prefix, str(i))) for i, v in enumerate(node)]
        return wholes.get(prefix, node)

    return rebuild(tree, "")


def make_layout(mesh, placements: Dict[str, Placement], params: Any,
                axis: str = "data") -> Optional[Layout]:
    """The layout of `placements` over the mesh's `axis` for the parameter
    tree `params` as it is before the cut (None without placements)."""
    if not placements:
        return None
    shapes = {p: tuple(t.shape) for p, t in named_leaves(params) if p in placements}
    return Layout(mesh=mesh, axis=axis, placements=dict(placements), shapes=shapes)


def shard_state(mesh, state: Dict[str, Any], placements: Dict[str, Placement],
                axis: str = "data") -> Dict[str, Any]:
    """A state (this rank's model slabs under a model axis, else whole) with
    its parameters, Adam moments and EMA shadow cut to this rank's part by
    `placements` over the mesh's `axis`: copies, so the whole tensors can be
    freed. The layout is kept under "layout"; a UNet of the parameters
    gathers its units on use (models/unet.py). Without placements, the state
    itself. Works on restored states: nothing is re-initialized."""
    layout = make_layout(mesh, placements, state["params"], axis)
    if layout is None:
        return state
    out = {k: _cut(layout, v) if k in _TREES else v for k, v in state.items()}
    opt = state["opt_state"]
    out["opt_state"] = {**opt, "mu": _cut(layout, opt["mu"]), "nu": _cut(layout, opt["nu"])}
    if axis == "data":
        for i, unet in enumerate((out["params"].get("diffusion") or {}).get("parts", ())):
            unet.gather_units(layout.at(f"diffusion/parts/{i}"))
    out["layout"] = layout
    return out


def whole_state(state: Dict[str, Any], timeout_s: Optional[float] = None,
                trees: Sequence[str] = ("params", "ema", "opt_state")) -> Dict[str, Any]:
    """The state with every placed leaf of `trees` gathered whole, without
    its layout (a collective over the layout's axis: its ranks call it
    together; each gather waits at most `timeout_s` seconds). What a
    checkpoint holds; ("params", "ema") is what evaluation and the samplers
    read. A state without a layout is returned as it is."""
    layout = state.get("layout")
    if layout is None:
        return state
    out = {k: v for k, v in state.items() if k != "layout"}
    for key in trees:
        if key == "opt_state":
            opt = state["opt_state"]
            out["opt_state"] = {**opt, "mu": _whole(layout, opt["mu"], timeout_s),
                                "nu": _whole(layout, opt["nu"], timeout_s)}
        elif key in state:
            out[key] = _whole(layout, state[key], timeout_s)
    return out
