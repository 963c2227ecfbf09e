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


def projected_features(dim: int = 16, res: int = 299, seed: int = 2024):
    """A feature function in place of Inception for the metrics' tests: a
    seeded projection of the resized [0, 255] pixels [B, res, res, 3] to
    `dim` values (numpy in, float32 numpy out). With more samples than
    `dim` the covariances have full rank, so FID is well-conditioned."""
    w = np.random.default_rng(seed).standard_normal((res * res * 3, dim))
    w = (w / np.sqrt(res * res * 3) / 128.0).astype(np.float32)

    def feats(x):
        x = np.asarray(x, np.float32).reshape(len(x), -1)
        return np.tanh(x @ w).astype(np.float32)

    return feats


def inject_features(monkeypatch, *caches, model_name: str = "inception_v3"):
    """Put one projected feature function into each extractor cache: the
    JAX package's takes arrays, the port's (the last) torch tensors."""
    feats = projected_features()
    for cache in caches[:-1]:
        monkeypatch.setitem(cache, model_name, lambda x: feats(x))
    monkeypatch.setitem(caches[-1], model_name,
                        lambda x: torch.from_numpy(feats(x.cpu().numpy())))
    return feats


def metric_overrides(*metrics, quick_num_gen=40):
    """Each metric in both resize modes through the feature net
    inception_v3, and SSIM/PSNR."""
    out = []
    for m in metrics:
        out += [f"model.evaluation.metrics.{m}.mode=[legacy_tensorflow,clean]",
                f"model.evaluation.metrics.{m}.model_name=[inception_v3,inception_v3]"]
    return out + ["model.evaluation.metrics.SSIM_and_PSNR.data_range=255",
                  f"model.evaluation.quick_num_gen={quick_num_gen}"]


def precompute_stats(monkeypatch, stats_dir, img_size):
    """The port's precompute_statistics over synthetic images in both
    modes, with a projected feature function in place of Inception."""
    monkeypatch.setenv("NFDPM_TPU_STATS_DIR", str(stats_dir))
    from nfdpm_tpu_torch.metrics import compute as tcompute

    inject_features(monkeypatch, tcompute._EXTRACTOR_CACHE)
    for mode in ("legacy_tensorflow", "clean"):
        tcompute.precompute_statistics(None, "", "synthetic", "train", img_size, mode,
                                       "inception_v3", limit=64, device="cpu")
