"""Weight bridge between the JAX package's parameter trees and the port's.

The JAX tree (nfdpm_tpu/models/glow.py:init_glow plus the prior of
training/nf_trainer.py:init_train_state), as nested dicts and tuples of
numpy arrays:

    {"flow": {"blocks": ({"steps": <K-stacked step>, "split": {"conv": zc | None}}, ...),
              "final_steps": <K-stacked step>},
     "prior": {"bias", "logs"} | {}}

The port's tree has the same keys, with each K-stacked step unstacked into a
list of K steps and every conv weight "w" turned from HWIO into OIHW. The
1x1-conv leaves (PLU p_mat/lower/upper/log_s/sign, or full-W "weight")
pass through unchanged.

`save_npz`/`load_npz` store the JAX-layout tree flattened under "/"-joined
keys; that is the weight format nfdpm_tpu_torch/serve.py reads.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import resolve_device

Tree = Any


def tree_to_device(tree: Tree, device: torch.device) -> Tree:
    """numpy leaves -> fp32 tensors on `device`; 4-D conv weights are kept in
    channels-last memory. Dicts, lists and None pass through."""
    if isinstance(tree, dict):
        return {k: tree_to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_device(v, device) for v in tree]
    if tree is None:
        return None
    t = torch.as_tensor(np.asarray(tree, np.float32)).to(device)
    return t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t


def _map_w(tree: Tree, fn) -> Tree:
    """Apply `fn` to every conv weight leaf (key "w")."""
    if isinstance(tree, dict):
        return {k: (fn(v) if k == "w" else _map_w(v, fn)) for k, v in tree.items()}
    return tree


def _map_leaves(tree: Tree, fn) -> Tree:
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(v, fn) for v in tree]
    return None if tree is None else fn(tree)


def _first_leaf(tree: Tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _unstack(stacked: Tree) -> list:
    k = np.asarray(_first_leaf(stacked)).shape[0]
    return [_map_leaves(stacked, lambda a, i=i: np.asarray(a)[i]) for i in range(k)]


def _stack(steps: list) -> Tree:
    if isinstance(steps[0], dict):
        return {k: _stack([s[k] for s in steps]) for k in steps[0]}
    return np.stack(steps)


def _hwio_to_oihw(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w, np.float32).transpose(3, 2, 0, 1))


def _oihw_to_hwio(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w, np.float32).transpose(2, 3, 1, 0))


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().contiguous().numpy()
    return np.asarray(t)


def _steps_from_jax(stacked: Tree) -> list:
    return [_map_w(s, _hwio_to_oihw) for s in _unstack(stacked)]


def from_jax_params(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """JAX-layout {"flow", "prior"} tree of numpy arrays -> the port's tree of
    tensors on `device` (the CUDA device unless named)."""
    flow = tree["flow"]
    blocks = []
    for block in flow["blocks"]:
        conv = (block.get("split") or {}).get("conv")
        blocks.append({"steps": _steps_from_jax(block["steps"]),
                       "split": {"conv": None if conv is None
                                 else _map_w(conv, _hwio_to_oihw)}})
    params = {"flow": {"blocks": blocks,
                       "final_steps": _steps_from_jax(flow["final_steps"])},
              "prior": dict(tree.get("prior") or {})}
    return tree_to_device(params, resolve_device(device))


def to_jax_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's {"flow", "prior"} tree -> the JAX layout, numpy on the host."""
    host = _map_leaves(params, _to_numpy)

    def steps_to_jax(steps):
        return _stack([_map_w(s, _oihw_to_hwio) for s in steps])

    flow = host["flow"]
    blocks = []
    for block in flow["blocks"]:
        conv = block["split"]["conv"]
        blocks.append({"steps": steps_to_jax(block["steps"]),
                       "split": {"conv": None if conv is None
                                 else _map_w(conv, _oihw_to_hwio)}})
    return {"flow": {"blocks": tuple(blocks),
                     "final_steps": steps_to_jax(flow["final_steps"])},
            "prior": dict(host.get("prior") or {})}


def _flatten(tree: Tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif tree is None:
        return
    else:
        out[prefix] = _to_numpy(tree)
        return
    for k, v in items:
        _flatten(v, f"{prefix}/{k}" if prefix else str(k), out)


def _as_sequences(tree: Tree) -> Tree:
    """Dicts whose keys are all decimal indices become tuples."""
    if not isinstance(tree, dict):
        return tree
    tree = {k: _as_sequences(v) for k, v in tree.items()}
    if tree and all(k.isdigit() for k in tree):
        return tuple(tree[k] for k in sorted(tree, key=int))
    return tree


def save_npz(path, tree: Dict[str, Any]) -> None:
    """Write a JAX-layout tree as one .npz, keys joined by "/". None leaves
    (a split without a learned prior) and empty dicts are left out; the
    loader reads their absence back as None and {}."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    np.savez(path, **flat)


def load_npz(path) -> Dict[str, Any]:
    """Read a tree written by `save_npz` (numpy leaves, tuples for indices)."""
    root: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            node = root
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return _as_sequences(root)
