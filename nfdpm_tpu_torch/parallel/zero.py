"""The collectives of ZeRO over the data axis: gradients reduce-scattered
into each rank's slabs, updated parameters all-gathered back. They run over
the mesh's data group (mesh.data_group), on what the rank holds of a leaf:
the whole leaf, or under a model axis its model slab.

The sharded leaves are taken in one fixed order; rank r's segment is the
concatenation of its slab of each (sharding_rules.Placement.slab). Every
rank's segment has the same length (a slab is 1/n of its leaf's axis, and a
K-stacked leaf's n owners hold K/n steps each), so one reduce_scatter_tensor
and one all_gather_into_tensor over flat buffers serve every leaf of a step.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import wait_within
from ..convert import named_leaves
from .sharding_rules import Placement, replace_leaves, shard_opt_state


def _segment(tensors: Sequence[torch.Tensor], placements: Sequence[Placement],
             rank: int) -> List[torch.Tensor]:
    return [pl.slab(t, rank) for t, pl in zip(tensors, placements)]


def _flat(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([p.reshape(-1) for p in parts])


def _check_equal(mesh, tensors, placements) -> int:
    sizes = {sum(s.numel() for s in _segment(tensors, placements, r))
             for r in range(mesh.data_world)}
    if len(sizes) != 1:
        raise ValueError(f"the ranks' ZeRO segments differ in length: {sorted(sizes)}")
    return sizes.pop()


def reduce_scatter_mean(mesh, grads: Sequence[torch.Tensor],
                        placements: Sequence[Placement]) -> List[torch.Tensor]:
    """This rank's slab of the rank-mean of each gradient: ONE
    reduce-scatter over the flat buffer of every rank's segment."""
    seg = _check_equal(mesh, grads, placements)
    inp = _flat([s for r in range(mesh.data_world) for s in _segment(grads, placements, r)])
    out = inp.new_empty(seg)
    dist.reduce_scatter_tensor(out, inp, group=mesh.data_group)
    out.div_(mesh.data_world)
    slabs, offset = [], 0
    for s in _segment(grads, placements, mesh.data_rank):
        slabs.append(out[offset:offset + s.numel()].view(s.shape))
        offset += s.numel()
    return slabs


def gather_segments(mesh, mine: Sequence[torch.Tensor], targets: Sequence[torch.Tensor],
                    placements: Sequence[Placement], timeout_s: Optional[float] = None) -> None:
    """Write every rank's slabs into `targets` (whole leaves): this rank's
    from `mine`, the others' from ONE all-gather of the segments (waited for
    at most `timeout_s` seconds, mesh.wait_within)."""
    seg = _check_equal(mesh, targets, placements)
    out = targets[0].new_empty(mesh.data_world * seg)
    work = dist.all_gather_into_tensor(out, _flat(mine), group=mesh.data_group, async_op=True)
    wait_within(mesh, work, timeout_s, "the all-gather of the Adam moments")
    for r in range(mesh.data_world):
        offset = r * seg
        for dst in _segment(targets, placements, r):
            dst.copy_(out[offset:offset + dst.numel()].view(dst.shape))
            offset += dst.numel()


def all_gather_params_(mesh, params: Sequence[torch.Tensor],
                       placements: Sequence[Placement]) -> None:
    """After each rank updated its slabs of `params` in place, give every
    rank the others' slabs: the parameters are whole and equal again."""
    gather_segments(mesh, _segment(params, placements, mesh.data_rank), params, placements)


def gather_moments(mesh, slabs: Sequence[torch.Tensor], like: Sequence[torch.Tensor],
                   placements: Sequence[Placement],
                   timeout_s: Optional[float] = None) -> List[torch.Tensor]:
    """Whole moments from every rank's slabs (`like`: the leaves they
    belong to, for shapes): what a checkpoint holds at any world size."""
    full = [torch.zeros_like(t, memory_format=torch.contiguous_format) for t in like]
    gather_segments(mesh, slabs, full, placements, timeout_s)
    return full


def shard_state(mesh, state: Dict[str, Any], placements: Dict[str, Placement]) -> Dict[str, Any]:
    """A train state with each placed leaf's moments cut to this rank's slab."""
    if not placements:
        return state
    return {**state, "opt_state": shard_opt_state(state["opt_state"], placements, mesh.data_rank)}


def whole_state(mesh, state: Dict[str, Any], placements: Dict[str, Placement],
                timeout_s: Optional[float] = None) -> Dict[str, Any]:
    """The state with whole Adam moments, gathered from every rank's slabs
    (a collective: every rank calls it, at most `timeout_s` seconds): what a
    checkpoint holds, the same tree at any world size. Without placements,
    the state itself."""
    if not placements:
        return state
    params = dict(named_leaves(state["params"]))
    paths = list(placements)
    opt = dict(state["opt_state"])
    for key in ("mu", "nu"):
        flat = dict(named_leaves(opt[key]))
        full = gather_moments(mesh, [flat[p] for p in paths], [params[p] for p in paths],
                              [placements[p] for p in paths], timeout_s)
        opt[key] = replace_leaves(opt[key], dict(zip(paths, full)))
    return {**state, "opt_state": opt}
