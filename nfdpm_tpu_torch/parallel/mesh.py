"""The ("data", "model") mesh of a launch and its data-axis collectives.

Counterpart of nfdpm_tpu/parallel/mesh.py. The JAX package's Mesh is a
grid of devices that one program spans; the port's is the process's place
in an SPMD launch: world size and rank, the launch's process group (None
for one process), the process's devices, and its coordinates on the two
axes with a process group for each.

Device order, as in the JAX package's make_mesh: rank r sits at data
index r // n_model and model index r % n_model, so every model group is a
contiguous block of ranks (inside one slice when `n_slices` > 1: the data
axis is laid out slice-major). The ranks of one model group hold the same
rows and draw the same noise; the model axis is tensor parallelism
(parallel/tensor_parallel.py), or under spatial partitioning
(`checked_spatial`, parallel/spatial.py) it carries the flow's image rows
instead: model rank m holds rows [m H/n, (m+1) H/n) of every flow
activation and the whole flow (the UNets of stage 2 stay tensor-parallel
over it).

Conventions, as in the JAX package:
  * a global batch is split on its leading axis into `n_data` equal
    contiguous row blocks, block d to the ranks at data index d;
  * parameters are replicated over the data axis, unless `parallel.fsdp`
    partitions them (parallel/zero.py); over the model axis a rank holds
    the slabs its "model" placements name (parallel/sharding_rules.py), or
    under the pipeline its stage's steps (parallel/pipeline.py);
  * the draws of a step are the global batch's, made by every rank from
    the same generator, of which each keeps its rows (ops/draws.py).

Every function here that reads rows, averages gradients or gathers rows
works along the data axis: `data_rank`, `data_world` (the processes on it)
and `data_group`. `rank`, `world` and `group` are the launch's: rank 0
writes the run's files (`is_writer`), parameters are broadcast from it.

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
from .tensor_parallel import ModelAxis


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    world: int                     # processes of the launch (or of `group`)
    rank: int                      # this process's index among them
    group: Optional[Any]           # their process group; None: one process
    devices: Tuple[torch.device, ...]  # this process's devices
    n_slices: int = 1
    n_model: int = 1               # processes on the model axis
    model_group: Optional[Any] = None  # this rank's model group (n_model > 1)
    data_subgroup: Optional[Any] = None  # its data group when n_model > 1
    # (None when the data axis has one process)
    spatial: bool = False          # the model axis carries the flow's image
    # rows, not slabs of its weights (checked_spatial)

    @property
    def data_rank(self) -> int:
        """This process's index on the data axis."""
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        """This process's index on the model axis."""
        return self.rank % self.n_model

    @property
    def data_world(self) -> int:
        """Processes on the data axis."""
        return self.world // self.n_model

    @property
    def data_group(self) -> Optional[Any]:
        """The process group of the ranks at this model index (the launch's
        group when there is no model axis)."""
        return self.group if self.n_model == 1 else self.data_subgroup

    @property
    def n_data(self) -> int:
        return self.data_world * len(self.devices)

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def model(self) -> Optional[ModelAxis]:
        """This rank's model axis, None without one."""
        if self.n_model == 1:
            return None
        return ModelAxis(n=self.n_model, index=self.model_rank, group=self.model_group,
                         rank=self.rank, world=self.world)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.n_data}, model={self.n_model}"
                f"{' (image rows)' if self.spatial else ''}, rank={self.rank}/{self.world}"
                f" (data {self.data_rank}, model {self.model_rank}), "
                f"devices={[str(d) for d in self.devices]})")


def axis_blocks(n: int, n_model: int) -> Tuple[List[List[int]], List[List[int]]]:
    """The model groups and the data groups of `n` ranks (indices into
    them): model group d is the contiguous block [d n_model, (d+1) n_model),
    data group m the ranks at model index m."""
    per = n // n_model
    return ([list(range(d * n_model, (d + 1) * n_model)) for d in range(per)],
            [list(range(m, n, n_model)) for m in range(n_model)])


def mesh_over(ranks: Sequence[int], n_model: int = 1, n_slices: int = 1, device=None,
              group=None, n_data: Optional[int] = None) -> Optional[Mesh]:
    """The mesh over the global `ranks` (their process `group`), None on a
    rank outside them. Under a launch EVERY rank of it calls this with the
    same arguments: the axes' process groups are made collectively, model
    groups first, then data groups. `n_model` must divide the ranks and
    `n_slices` the data axis; `n_data` may only restate the data axis."""
    ranks = list(ranks)
    world = len(ranks)
    if n_model < 1 or world % n_model:
        raise ValueError(f"n_model={n_model} does not divide the {world} processes of the "
                         "launch: the model axis needs n_model processes a data index")
    per = world // n_model
    if n_data is not None and n_data != per:
        raise ValueError(f"the data axis spans the {world} processes of the launch over "
                         f"n_model={n_model}, {per} data indices, not {n_data}")
    if n_slices < 1 or per % n_slices:
        raise ValueError(f"data axis ({per}) must be divisible by n_slices ({n_slices})"
                         " — data parallelism is what spans slices")
    me = dist.get_rank() if dist.is_initialized() else 0
    model_group = data_group = None
    if n_model > 1:
        models, datas = axis_blocks(world, n_model)
        for block in models:
            pg = dist.new_group([ranks[i] for i in block])
            if me in (ranks[i] for i in block):
                model_group = pg
        if per > 1:
            for block in datas:
                pg = dist.new_group([ranks[i] for i in block])
                if me in (ranks[i] for i in block):
                    data_group = pg
    if me not in ranks:
        return None
    return Mesh(world=world, rank=ranks.index(me), group=group,
                devices=(resolve_device(device),), n_slices=n_slices, n_model=n_model,
                model_group=model_group, data_subgroup=data_group)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, n_slices: int = 1,
              device=None, group=None) -> Mesh:
    """The ("data", "model") mesh of this process in the running launch
    (one process without one) over every process of `group` (default:
    all), one device each: n_data = world / n_model. An `n_model` that does
    not divide the world raises (nothing runs replicated in its place);
    `n_data` may only restate world / n_model; `n_slices` must divide it.
    Every rank of the launch calls it (the axes' groups are collective)."""
    if dist.is_initialized():
        group = group if group is not None else dist.group.WORLD
        ranks = dist.get_process_group_ranks(group)
    else:
        group, ranks = None, [0]
    return mesh_over(ranks, n_model, n_slices, device, group, n_data)


def n_model_of(mesh: Optional[Mesh]) -> int:
    """The mesh's model axis size (1 without a mesh)."""
    return 1 if mesh is None else mesh.n_model


def model_of(mesh: Optional[Mesh]) -> Optional[ModelAxis]:
    """The mesh's model axis (None without a mesh or without one)."""
    return None if mesh is None else mesh.model


def flow_model_of(mesh: Optional[Mesh]) -> Optional[ModelAxis]:
    """The model axis over which the flow holds slabs of its coupling CNNs:
    the mesh's, None without one or under spatial partitioning."""
    return None if mesh is None or mesh.spatial else mesh.model


def rows_of(mesh: Optional[Mesh]) -> Optional[ModelAxis]:
    """The model axis over which a spatial train step splits the flow's
    image rows (None without spatial partitioning)."""
    return mesh.model if mesh is not None and mesh.spatial else None


def flat(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """The launch's ranks all on the data axis, no model axis: the view of
    part-parallel training's launch-wide steps (the merge, the sampling),
    where the parts' meshes hold the model axis, and of the steps that run
    the whole flow on every rank (the pipeline's and spatial partitioning's
    evaluation and sampling)."""
    if mesh is None or mesh.n_model == 1:
        return mesh
    return dataclasses.replace(mesh, n_model=1, model_group=None, data_subgroup=None,
                               spatial=False)


def check_spatial(img_size: int, levels: int, n_model: int) -> None:
    """The JAX package's guard of spatial partitioning
    (checked_spatial_sharding): the deepest Glow level's img_size / 2^levels
    rows must divide over the model axis and leave every rank at least 2.
    The port's halo exchange is exact below that too; the guard is kept so
    that both packages accept the same configurations. Raises ValueError
    outside it."""
    deepest = img_size >> levels
    if deepest % n_model or deepest // n_model < 2:
        raise ValueError(
            f"parallel.spatial needs (img_size/2^L)/n_model >= 2 and "
            f"divisible; got {img_size}/2^{levels}={deepest} over "
            f"model={n_model}")


def checked_spatial(mesh: Mesh, img_size: int, levels: int) -> Mesh:
    """The mesh with its model axis carrying image rows (spatial
    partitioning), after the guard (check_spatial)."""
    check_spatial(img_size, levels, mesh.n_model)
    return dataclasses.replace(mesh, spatial=True)


def spatial_for_training(mesh: Optional[Mesh], img_size: int, levels: int,
                         logger) -> Optional[Mesh]:
    """The trainers' `spatial=True`, as the JAX package's: the checked
    spatial mesh under a model axis (logged), else the mesh as it is with
    a warning that the option has no effect."""
    if n_model_of(mesh) > 1:
        mesh = checked_spatial(mesh, img_size, levels)
        logger.info(f"Spatial partitioning: H over model={mesh.n_model}")
    else:
        logger.warning("parallel.spatial=true has no effect without a model "
                       "axis — set parallel.n_model>1")
    return mesh


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


# -- rows (the data axis) ------------------------------------------------------

def data_sharding(mesh: Mesh, n: int) -> slice:
    """This process's rows of a global batch of `n`: the contiguous block of
    its data index. Raises when `n` does not divide over the data axis."""
    if n % mesh.data_world:
        raise ValueError(f"a global batch of {n} does not split over {mesh.data_world} "
                         "data ranks")
    per = n // mesh.data_world
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def shard_batch(mesh: Mesh, batch, microbatches: int = 1):
    """This process's rows of a global batch (array or tensor): of each of
    the `microbatches` consecutive slices its block, joined, so that
    microbatch i of the result is this rank's part of the global
    microbatch i. Raises when the batch does not divide."""
    if mesh.data_world == 1:
        return batch
    n = len(batch)
    if n % (microbatches * mesh.data_world):
        raise ValueError(f"a global batch of {n} does not split into {microbatches} "
                         f"microbatches over {mesh.data_world} data ranks")
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
    when the data axis has one process."""
    if mesh is None or mesh.data_world == 1:
        return generator
    d = mesh.data_rank
    return RowGenerator(generator, d * n_local, (d + 1) * n_local, mesh.data_world * n_local)


def split_rows(mesh: Optional[Mesh], n: int) -> Tuple[int, int]:
    """This rank's rows [start, stop) of a draw of `n` that need not divide:
    blocks of ceil(n / data ranks); a rank past the end takes the last row
    again, which `gather_split_rows` drops."""
    if mesh is None or mesh.data_world == 1:
        return 0, n
    per = -(-n // mesh.data_world)
    start, stop = min(n, mesh.data_rank * per), min(n, (mesh.data_rank + 1) * per)
    return (n - 1, n) if start == stop else (start, stop)


def gather_split_rows(mesh: Optional[Mesh], n: int, x: torch.Tensor) -> torch.Tensor:
    """Every data rank's `split_rows` block joined: the n rows in order, on
    every rank (the blocks padded to one length for the all-gather)."""
    if mesh is None or mesh.data_world == 1:
        return x
    per = -(-n // mesh.data_world)
    if x.shape[0] < per:
        x = torch.cat([x, x[-1:].expand(per - x.shape[0], *x.shape[1:])])
    full = all_gather_rows(mesh, x)
    keep = [r * per + i for r in range(mesh.data_world)
            for i in range(max(0, min(n, (r + 1) * per) - r * per))]
    return full[torch.as_tensor(keep, device=full.device)]


def sample_rows(mesh: Optional[Mesh], n: int, generator: torch.Generator, sample):
    """`sample(n_rows, generator)` of this rank's rows of an n-row draw from
    `generator` (a RowGenerator over the whole draw), gathered: every rank
    holds the n samples, bit for bit the ones one device draws."""
    start, stop = split_rows(mesh, n)
    if mesh is None or mesh.data_world == 1:
        return sample(n, generator)
    rows = sample(stop - start, RowGenerator(generator, start, stop, n))
    return gather_split_rows(mesh, n, rows)


# -- collectives (the data axis) -------------------------------------------------

def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat_(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view(t.shape))
        offset += n


def all_reduce_mean_(mesh: Optional[Mesh], tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the data ranks, in place, with
    ONE all-reduce over a flat buffer of all of them (not one a tensor).
    One process on the data axis: nothing to do. At world 1 under a process
    group the all-reduce still runs and the division is by 1, so the values
    stay bit for bit."""
    if mesh is None or mesh.data_group is None or not tensors:
        return
    flat = _flat(tensors)
    dist.all_reduce(flat, group=mesh.data_group)
    flat.div_(mesh.data_world)
    _unflat_(flat, tensors)


def all_reduce_sum_(mesh: Optional[Mesh], tensor: torch.Tensor) -> torch.Tensor:
    """The tensor summed over the data ranks, in place."""
    if mesh is not None and mesh.data_group is not None:
        dist.all_reduce(tensor, group=mesh.data_group)
    return tensor


def all_gather_rows(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The data ranks' row blocks `x` (the same shape on each) joined in
    data-rank order: samples, features, scores."""
    if mesh is None or mesh.data_group is None or mesh.data_world == 1:
        return x
    x = x.contiguous()
    out = x.new_empty((mesh.data_world * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=mesh.data_group)
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
