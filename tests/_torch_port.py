"""Shared helpers for the tests that hold nfdpm_tpu_torch against nfdpm_tpu.

Inputs and weights are made with numpy from a seed and handed to both
packages; JAX runs on the CPU, PyTorch on the CPU (device="cpu")."""

from __future__ import annotations

import jax
import numpy as np
import torch

# Leaves a Glow starts with at zero (actnorms, zeroconvs, priors). Tests give
# them small random values so that no part of a step is the identity. The
# permutation matrix and the sign of a PLU 1x1 conv stay as they are.
_FIXED = ("p_mat", "sign")


def randomize(tree, seed: int, scale: float = 0.05):
    """Add seeded N(0, scale^2) noise to every leaf but p_mat and sign."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        if node is None or name in _FIXED:
            return node
        a = np.asarray(node, np.float32)
        return (a + scale * rng.standard_normal(a.shape)).astype(np.float32)

    return walk(tree)


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_tree(tree):
    """A JAX-layout sub-tree (one step, a zeroconv, a coupling net) -> the
    port's layout on the CPU: conv weights "w" HWIO -> OIHW."""
    from nfdpm_tpu_torch.convert import tree_to_device

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if name == "w":
            return np.asarray(node, np.float32).transpose(3, 2, 0, 1)
        return node

    return tree_to_device(walk(to_numpy_tree(tree)), torch.device("cpu"))


def t(a) -> torch.Tensor:
    """numpy/JAX array -> CPU fp32 tensor."""
    return torch.from_numpy(np.array(a, np.float32))


def close(actual, expected, atol=1e-5, rtol=0.0):
    a = actual.detach().cpu().numpy() if isinstance(actual, torch.Tensor) else np.asarray(actual)
    np.testing.assert_allclose(a, np.asarray(expected), atol=atol, rtol=rtol)
