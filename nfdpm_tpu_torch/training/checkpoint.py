"""Checkpoints of train states, and the run directory's architecture file.

Counterpart of nfdpm_tpu/training/checkpoint.py with torch.save in place of
orbax: a state {"params", "opt_state", "step"} (and the diffusion
trainer's "ema") of plain tensors (on the host), ints and nested dicts and
lists, a module saved as the dict of its parameters by name, goes to

    <run_dir>/checkpoints/model_{prefix}_{epoch:03d}.pt

written under a temporary name and renamed, so an interrupted write never
leaves a truncated checkpoint. `architecture.json` beside it holds the
hyperparameters a later run needs to rebuild the flow. Writes are
synchronous; under data parallelism rank 0 writes and the ranks meet at a
barrier after each save. A checkpoint holds whole tensors at any mesh
shape: the trainers gather ZeRO's moment slabs and the model axis's
parameter slabs before they save (nf_trainer.whole_nf_state,
diffusion_trainer.whole_diffusion_state), and cut a restored state to a
rank's slabs after they load it. `checkpoints/mid_epoch.json` marks a checkpoint that an
interrupt wrote in the middle of an epoch, with the JAX package's keys and
values, so that a resume continues from the exact batch.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional

import torch

from .. import resolve_device
from ..convert import map_tree, trainable


def checkpoint_path(run_dir: str, prefix: str, epoch: int) -> str:
    return os.path.abspath(os.path.join(run_dir, "checkpoints",
                                        f"model_{prefix}_{epoch:03d}.pt"))


def save_architecture(run_dir: str, arch: Dict[str, Any],
                      filename: str = "architecture.json") -> None:
    with open(os.path.join(run_dir, filename), "w") as f:
        json.dump(arch, f, indent=2)


def load_architecture(run_dir: str,
                      filename: str = "architecture.json") -> Dict[str, Any]:
    with open(os.path.join(run_dir, filename)) as f:
        return json.load(f)


def _place(tree: Any, device: torch.device) -> Any:
    """Tensors onto `device`, 4-D conv weights in channels-last memory (as
    convert.tree_to_device keeps them)."""
    def place(t):
        t = t.to(device)
        return t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t

    return map_tree(tree, place)


def save_state(run_dir: str, prefix: str, epoch: int, state: Any, mesh=None,
               timeout_s: Optional[float] = None) -> str:
    """Write the state's checkpoint for `epoch`; returns its path. Under a
    data-parallel `mesh` only rank 0 writes, and every rank waits at a
    barrier after the write (at most `timeout_s` seconds: the emergency
    checkpoint after an interrupt must not hang on a rank that is gone)."""
    from ..parallel.mesh import barrier, is_writer

    path = checkpoint_path(run_dir, prefix, epoch)
    if is_writer(mesh):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        host = map_tree(state, lambda t: t.detach().cpu())
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            torch.save(host, tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    barrier(mesh, timeout_s, f"the barrier after writing {os.path.basename(path)}")
    return path


def _load(run_dir: str, prefix: str, epoch: int) -> Any:
    return torch.load(checkpoint_path(run_dir, prefix, epoch), map_location="cpu",
                      weights_only=True)


def restore_state(run_dir: str, prefix: str, epoch: int, device=None) -> Any:
    """The whole train state on `device` (CUDA unless named), its parameters
    as autograd leaves again."""
    device = resolve_device(device)
    state = _place(_load(run_dir, prefix, epoch), device)
    state["params"] = trainable(state["params"])
    return state


def checkpoint_keys(run_dir: str, prefix: str, epoch: int) -> list:
    """Top-level keys of a saved state ("ema" among them when the run kept
    one)."""
    return list(_load(run_dir, prefix, epoch).keys())


def restore_params(run_dir: str, prefix: str, epoch: int, device=None,
                   prefer_ema: bool = False) -> Any:
    """Only the `params` subtree, on `device`: needs no optimizer, so a run
    trained with any optimizer or schedule restores for scoring and sampling.
    `prefer_ema=True` puts the checkpoint's EMA weights in place of the live
    ones where it has them (the diffusion trainer's `ema_decay`)."""
    device = resolve_device(device)
    tree = _load(run_dir, prefix, epoch)
    params = tree["params"]
    if prefer_ema and "ema" in tree:
        params = {**params, **tree["ema"]}
    return _place(params, device)


def _marker_path(run_dir: str) -> str:
    return os.path.join(run_dir, "checkpoints", "mid_epoch.json")


def save_mid_epoch_marker(run_dir: str, prefix: str, epoch: int,
                          batch_in_epoch: int) -> None:
    """Record that the checkpoint of `epoch` was written after
    `batch_in_epoch` train batches of that epoch (the trainers' interrupt
    path), so that a resume re-enters the epoch at that batch
    (`resume_batch`)."""
    os.makedirs(os.path.dirname(_marker_path(run_dir)), exist_ok=True)
    with open(_marker_path(run_dir), "w") as f:
        json.dump({"prefix": prefix, "epoch": epoch, "batch_in_epoch": batch_in_epoch}, f)


def load_mid_epoch_marker(run_dir: str) -> Optional[Dict[str, Any]]:
    if not os.path.exists(_marker_path(run_dir)):
        return None
    with open(_marker_path(run_dir)) as f:
        return json.load(f)


def clear_mid_epoch_marker(run_dir: str) -> None:
    """Remove the marker: a run that completes leaves none behind."""
    if os.path.exists(_marker_path(run_dir)):
        os.remove(_marker_path(run_dir))


def _epochs(run_dir: str, prefix: str, orbax: bool = False) -> list:
    """Epochs of the port's checkpoint files model_{prefix}_NNN.pt, or with
    `orbax=True` of the JAX package's checkpoint directories model_{prefix}_NNN."""
    pat = re.compile(rf"model_{prefix}_(\d+)" + ("" if orbax else r"\.pt") + "$")
    d = os.path.join(run_dir, "checkpoints")
    names = os.listdir(d) if os.path.isdir(d) else []
    return [int(m.group(1)) for f in names if (m := pat.match(f))
            and os.path.isdir(os.path.join(d, f)) == orbax]


def latest_epoch(run_dir: str, prefix: str) -> Optional[int]:
    return max(_epochs(run_dir, prefix), default=None)


def orbax_epochs(run_dir: str, prefix: str) -> list:
    """Epochs of the orbax checkpoints a JAX run directory holds, which the
    port does not read (tools/jax_run_to_torch.py converts them)."""
    return _epochs(run_dir, prefix, orbax=True)
