"""Shared helpers for the tests that hold nfdpm_tpu_torch against nfdpm_tpu.

Inputs and weights are made with numpy from a seed and handed to both
packages; JAX runs on the CPU, PyTorch on the CPU (device="cpu")."""

from __future__ import annotations

import contextlib

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


def adam_moments(opt_state, params):
    """(mu, nu, count) of the optax state of nfdpm_tpu's make_optimizer, as
    numpy trees shaped like `params`, with zeros where optax masks a leaf
    out (p_mat, sign and, under fixed_prior, the prior)."""
    import optax

    found = []

    def visit(node):
        if isinstance(node, optax.ScaleByAdamState):
            found.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, (tuple, list)):  # named tuples of optax included
            for v in node:
                visit(v)

    visit(opt_state)
    (state,) = found

    def fill(moment, like):
        if isinstance(like, dict):
            return {k: fill(moment[k] if isinstance(moment, dict) and k in moment else None, v)
                    for k, v in like.items()}
        if isinstance(like, (tuple, list)):
            given = isinstance(moment, (tuple, list))
            return type(like)(fill(moment[i] if given else None, v)
                              for i, v in enumerate(like))
        if like is None:
            return None
        if moment is None or isinstance(moment, optax.MaskedNode):
            return np.zeros(np.shape(like), np.float32)
        return np.asarray(moment)

    return fill(state.mu, params), fill(state.nu, params), int(state.count)


# -- a small analytic model in place of the UNet, written in both frameworks,
# so that a diffusion process compiles in a second --------------------------

def model_weights(c, out, seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((c, out)) / np.sqrt(c)).astype(np.float32),
            "s": (0.5 * rng.standard_normal((c, out)) / np.sqrt(c)).astype(np.float32)}


def jax_model(p, x, steps, sc):
    """tanh(x W + 0.1 sin(0.37 t) + sc S); t [B] or length 1."""
    import jax.numpy as jnp

    h = x @ p["w"] + 0.1 * jnp.sin(0.37 * steps.astype(jnp.float32)).reshape(-1, 1, 1, 1)
    if sc is not None:
        h = h + sc @ p["s"]
    return jnp.tanh(h)


def torch_model(p, x, steps, sc):
    h = x @ p["w"] + 0.1 * torch.sin(0.37 * steps.float()).reshape(-1, 1, 1, 1)
    if sc is not None:
        h = h + sc @ p["s"]
    return torch.tanh(h)


@contextlib.contextmanager
def one_torch_thread():
    """PyTorch on one CPU thread: at the tests' tiny sizes its thread pool
    costs more than it gives, the more so beside other test workers (a
    stage-2 CPU training run took 1.3 s on one thread and 35 s on eight of a
    loaded 8-core host)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
