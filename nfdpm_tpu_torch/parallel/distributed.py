"""Multi-process start of a data-parallel run.

Counterpart of nfdpm_tpu/parallel/distributed.py. One process per rank,
launched by torchrun:

    torchrun --nproc-per-node=N -m nfdpm_tpu_torch.run_baseline ...

`initialize()` reads torchrun's RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR
and MASTER_PORT, or else the JAX package's NFDPM_NUM_PROCESSES,
NFDPM_PROCESS_ID and NFDPM_COORDINATOR (host:port), and joins the process
group. The backend is NCCL, which needs CUDA; gloo only when the caller or
NFDPM_DIST_BACKEND=gloo names it. A failure raises: nothing drops to one
process or to the CPU.

Every rank loads the same global batch from the deterministic Loader
(data/pipeline.py) and keeps its own rows (`distribute_batch`).
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist


BACKEND_ENV = "NFDPM_DIST_BACKEND"


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def launch_env() -> Optional[Dict[str, Any]]:
    """{"rank", "world_size", "local_rank", "init_method"} from torchrun's
    variables or the JAX package's, None when neither names a launch."""
    world = _env_int("WORLD_SIZE")
    if world is not None:
        if not (os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT")):
            raise RuntimeError("WORLD_SIZE is set but MASTER_ADDR or MASTER_PORT is not")
        # env:// joins torchrun's own store (TORCHELASTIC_USE_AGENT_STORE)
        return {"rank": _env_int("RANK") or 0, "world_size": world,
                "local_rank": _env_int("LOCAL_RANK") or 0, "init_method": "env://"}
    world = _env_int("NFDPM_NUM_PROCESSES")
    if world is None or world <= 1:
        return None
    coordinator = os.environ.get("NFDPM_COORDINATOR")
    if not coordinator:
        raise RuntimeError("NFDPM_NUM_PROCESSES > 1 needs NFDPM_COORDINATOR (host:port)")
    rank = _env_int("NFDPM_PROCESS_ID") or 0
    local = _env_int("LOCAL_RANK")
    return {"rank": rank, "world_size": world,
            "local_rank": rank if local is None else local,
            "init_method": f"tcp://{coordinator}"}


def initialize(backend: Optional[str] = None, device=None,
               init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, local_rank: Optional[int] = None,
               timeout_s: float = 1800.0) -> bool:
    """Join the process group of this launch; True when a group is up.

    Nothing happens (False) without a launch: no torchrun variables and
    NFDPM_NUM_PROCESSES unset or 1, and no `world_size` given. Under a
    launch, `torch.cuda.set_device(local_rank)` comes before any CUDA use
    unless `device` names the CPU. `backend` (else NFDPM_DIST_BACKEND, else
    "nccl") must be "nccl" or "gloo"; NCCL without CUDA, or NCCL with
    `device="cpu"`, raises. Already initialized: the running group stays."""
    if dist.is_initialized():
        return True
    env = launch_env() or {}
    world_size = world_size if world_size is not None else env.get("world_size")
    if world_size is None:
        return False
    rank = rank if rank is not None else env.get("rank", 0)
    local_rank = local_rank if local_rank is not None else env.get("local_rank", 0)
    init_method = init_method or env.get("init_method")
    if init_method is None:
        raise RuntimeError("a process group needs an init method (MASTER_ADDR/MASTER_PORT, "
                           "NFDPM_COORDINATOR or init_method=)")
    backend = backend or os.environ.get(BACKEND_ENV, "nccl")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if backend == "nccl" and (on_cpu or not torch.cuda.is_available()):
        raise RuntimeError("the NCCL backend needs CUDA devices"
                           + (" and device=cpu was asked for" if on_cpu
                              else ", and none is available")
                           + f"; name gloo ({BACKEND_ENV}=gloo) to run on the CPU")
    kwargs = {}
    if not on_cpu:
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: no CUDA device is available; pass device='cpu' "
                               "to run on the CPU")
        torch.cuda.set_device(local_rank)
        if backend == "nccl":
            kwargs["device_id"] = torch.device("cuda", local_rank)
    dist.init_process_group(backend, init_method=init_method, world_size=int(world_size),
                            rank=int(rank), timeout=datetime.timedelta(seconds=timeout_s),
                            **kwargs)
    return True


def process_info() -> Dict[str, int]:
    """{"process_index", "process_count"}, (0, 1) without a group."""
    if not dist.is_initialized():
        return {"process_index": 0, "process_count": 1}
    return {"process_index": dist.get_rank(), "process_count": dist.get_world_size()}


def distribute_batch(mesh, global_batch, microbatches: int = 1):
    """This rank's rows of the global batch every rank loaded (the Loader is
    deterministic): mesh.shard_batch, `host_shard` of each microbatch. One
    process: the batch itself."""
    from .mesh import shard_batch

    return global_batch if mesh is None else shard_batch(mesh, global_batch, microbatches)


def shutdown() -> None:
    """Leave the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()
