"""The data-axis mesh and its collectives.

Counterpart of nfdpm_tpu/parallel/mesh.py along the "data" axis. The JAX
package's Mesh is a grid of devices that one program spans; the port's is
the process's place on the data axis of an SPMD launch: world size, rank,
process group (None for one process) and the process's devices. Its shape
is {"data": n, "model": 1}: the model axis is not ported (make_mesh with
n_model > 1 raises).

Conventions, as in the JAX package:
  * a global batch is split on its leading axis into `n_data` equal
    contiguous row blocks, block r to rank r (ranks are laid out
    slice-major when `n_slices` > 1, so a slice is a contiguous block);
  * parameters are replicated: every rank holds them whole and equal;
  * the draws of a step are the global batch's, made by every rank from
    the same generator, of which each keeps its rows (ops/draws.py).

One process over several local devices (`local_mesh`) is the
single-process data parallelism of `serve --data-parallel` and
`precompute_stats --data-parallel`: one replica of the model a device, a
batch split across them, no process group.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import resolve_device
from ..convert import named_leaves
from ..ops.draws import RowGenerator

NOT_PORTED = "(ROADMAP: tensor, pipeline and spatial parallelism)"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    world: int                     # processes on the data axis
    rank: int                      # this process's index among them
    group: Optional[Any]           # their process group; None: one process
    devices: Tuple[torch.device, ...]  # this process's devices
    n_slices: int = 1

    @property
    def n_data(self) -> int:
        return self.world * len(self.devices)

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": 1}

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.n_data}, model=1, rank={self.rank}/{self.world}, "
                f"devices={[str(d) for d in self.devices]})")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, n_slices: int = 1,
              device=None, group=None) -> Mesh:
    """The mesh of this process in the running launch (one process without
    one): the data axis spans every process of `group` (default: all), one
    device each. `n_data` may only restate that count; `n_slices` must
    divide it (data parallelism is what spans slices)."""
    if n_model != 1:
        raise NotImplementedError(f"n_model={n_model}: the model axis is not ported "
                                  + NOT_PORTED)
    if dist.is_initialized():
        group = group if group is not None else dist.group.WORLD
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        group, world, rank = None, 1, 0
    if n_data is None:
        n_data = world
    if n_data != world:
        raise ValueError(f"the data axis spans the {world} processes of the launch, "
                         f"not {n_data}")
    if n_slices < 1 or n_data % n_slices:
        raise ValueError(f"data axis ({n_data}) must be divisible by n_slices ({n_slices})"
                         " — data parallelism is what spans slices")
    return Mesh(world=world, rank=rank, group=group, devices=(resolve_device(device),),
                n_slices=n_slices)


def local_mesh(devices: Sequence) -> Mesh:
    """One process over `devices`: a replica on each, batches split across
    them (serve and precompute_stats --data-parallel)."""
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(world=1, rank=0, group=None, devices=devices)


def visible_devices(device=None) -> List[torch.device]:
    """Every visible CUDA device when `device` is None or "cuda", else the one
    device it names (the CPU, or one card); no device is skipped, and CUDA
    wanted but absent raises."""
    dev = resolve_device(device)
    if dev.type != "cuda" or (device is not None and torch.device(device).index is not None):
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


# -- rows ----------------------------------------------------------------------

def data_sharding(mesh: Mesh, n: int) -> slice:
    """This process's rows of a global batch of `n`: the rank's contiguous
    block. Raises when `n` does not divide over the processes."""
    if n % mesh.world:
        raise ValueError(f"a global batch of {n} does not split over {mesh.world} ranks")
    per = n // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(mesh: Mesh, batch, microbatches: int = 1):
    """This process's rows of a global batch (array or tensor): of each of
    the `microbatches` consecutive slices its block, joined, so that
    microbatch i of the result is this rank's part of the global
    microbatch i. Raises when the batch does not divide."""
    if mesh.world == 1:
        return batch
    n = len(batch)
    if n % (microbatches * mesh.world):
        raise ValueError(f"a global batch of {n} does not split into {microbatches} "
                         f"microbatches over {mesh.world} ranks")
    per = n // microbatches
    parts = [batch[i * per:(i + 1) * per][data_sharding(mesh, per)]
             for i in range(microbatches)]
    if len(parts) == 1:
        return parts[0]
    if isinstance(batch, torch.Tensor):
        return torch.cat(parts)
    import numpy as np

    return np.concatenate(parts)


def row_generator(mesh: Optional[Mesh], generator: torch.Generator, n_local: int):
    """`generator` for a draw of this rank's `n_local` rows: a RowGenerator
    over the global batch's draw (ops/draws.py), or the generator itself
    for one process."""
    if mesh is None or mesh.world == 1:
        return generator
    return RowGenerator(generator, mesh.rank * n_local, (mesh.rank + 1) * n_local,
                        mesh.world * n_local)


def split_rows(mesh: Optional[Mesh], n: int) -> Tuple[int, int]:
    """This rank's rows [start, stop) of a draw of `n` that need not divide:
    blocks of ceil(n / world); a rank past the end takes the last row
    again, which `gather_split_rows` drops."""
    if mesh is None or mesh.world == 1:
        return 0, n
    per = -(-n // mesh.world)
    start, stop = min(n, mesh.rank * per), min(n, (mesh.rank + 1) * per)
    return (n - 1, n) if start == stop else (start, stop)


def gather_split_rows(mesh: Optional[Mesh], n: int, x: torch.Tensor) -> torch.Tensor:
    """Every rank's `split_rows` block joined: the n rows in order, on every
    rank (the blocks padded to one length for the all-gather)."""
    if mesh is None or mesh.world == 1:
        return x
    per = -(-n // mesh.world)
    if x.shape[0] < per:
        x = torch.cat([x, x[-1:].expand(per - x.shape[0], *x.shape[1:])])
    full = all_gather_rows(mesh, x)
    keep = [r * per + i for r in range(mesh.world)
            for i in range(max(0, min(n, (r + 1) * per) - r * per))]
    return full[torch.as_tensor(keep, device=full.device)]


def sample_rows(mesh: Optional[Mesh], n: int, generator: torch.Generator, sample):
    """`sample(n_rows, generator)` of this rank's rows of an n-row draw from
    `generator` (a RowGenerator over the whole draw), gathered: every rank
    holds the n samples, bit for bit the ones one device draws."""
    start, stop = split_rows(mesh, n)
    if mesh is None or mesh.world == 1:
        return sample(n, generator)
    rows = sample(stop - start, RowGenerator(generator, start, stop, n))
    return gather_split_rows(mesh, n, rows)


# -- collectives ---------------------------------------------------------------

def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat_(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view(t.shape))
        offset += n


def all_reduce_mean_(mesh: Optional[Mesh], tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks, in place, with ONE
    all-reduce over a flat buffer of all of them (not one a tensor). One
    process: nothing to do. At world 1 under a process group the all-reduce
    still runs and the division is by 1, so the values stay bit for bit."""
    if mesh is None or mesh.group is None or not tensors:
        return
    flat = _flat(tensors)
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.world)
    _unflat_(flat, tensors)


def all_reduce_sum_(mesh: Optional[Mesh], tensor: torch.Tensor) -> torch.Tensor:
    """The tensor summed over the ranks, in place."""
    if mesh is not None and mesh.group is not None:
        dist.all_reduce(tensor, group=mesh.group)
    return tensor


def all_gather_rows(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The ranks' row blocks `x` (the same shape on each) joined in rank
    order: samples, features, scores."""
    if mesh is None or mesh.group is None or mesh.world == 1:
        return x
    x = x.contiguous()
    out = x.new_empty((mesh.world * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=mesh.group)
    return out


def replicate(mesh: Optional[Mesh], tree: Any) -> Any:
    """Every tensor of `tree` (modules' parameters too) made rank 0's, in
    place, by one broadcast a tensor; returns the tree."""
    if mesh is None or mesh.group is None or mesh.world == 1:
        return tree
    src = dist.get_global_rank(mesh.group, 0)
    with torch.no_grad():
        for _, t in named_leaves(tree):
            if t.is_contiguous():
                dist.broadcast(t.data, src=src, group=mesh.group)
            else:  # a channels-last conv weight
                buf = t.detach().contiguous()
                dist.broadcast(buf, src=src, group=mesh.group)
                t.data.copy_(buf)
    return tree


def wait_within(mesh: Mesh, work, timeout_s: Optional[float], what: str) -> None:
    """Wait for the asynchronous collective `work`, at most `timeout_s`
    seconds (None: as long as it takes); past that raise with this rank's
    name instead of hanging on a rank that is gone."""
    if timeout_s is not None:
        deadline = time.monotonic() + timeout_s
        while not work.is_completed():
            if time.monotonic() > deadline:
                raise RuntimeError(f"rank {mesh.rank} of {mesh.world}: {what} did not "
                                   f"complete within {timeout_s:g} s; another rank is gone "
                                   "or stuck")
            time.sleep(0.01)
    try:
        work.wait()
    except Exception as e:  # the backend's own failure, named by this rank
        raise RuntimeError(f"rank {mesh.rank} of {mesh.world}: {what} failed: {e}") from e


def barrier(mesh: Optional[Mesh], timeout_s: Optional[float] = None,
            what: str = "the barrier") -> None:
    """Wait for every rank (at most `timeout_s` seconds, see wait_within)."""
    if mesh is not None and mesh.group is not None:
        wait_within(mesh, dist.barrier(group=mesh.group, async_op=True), timeout_s, what)


def is_writer(mesh: Optional[Mesh]) -> bool:
    """Whether this process writes the run's files (rank 0 only)."""
    return mesh is None or mesh.rank == 0
