"""FID / KID scoring: features on the device, score math on the host, stats store.

Counterpart of nfdpm_tpu/metrics/fid.py (clean-fid's pipeline):

  * Feature extraction runs uint8 images, resized, through the Inception-v3
    (2048-d) or CLIP ViT-B/32 (512-d) feature net on the device.
  * Resize modes: "clean" = PIL bicubic on float images, one channel at a
    time, on the host (clean-fid's high-quality mode); "legacy_tensorflow"
    = TF1 bilinear without antialias, a gather on the device.
  * FID: Frechet distance with scipy's sqrtm; KID: the unbiased
    polynomial-kernel MMD over 100 subsets of at most 1000, in float64
    numpy, so that both packages give the same number from the same
    features.
  * Stats store: one npz per (dataset, mode, model, split, res) holding
    mu/sigma (FID) and the raw features (KID), under the JAX package's file
    names and keys, so each package reads the other's files. The directory
    is NFDPM_TPU_STATS_DIR, by default ~/.nfdpm_tpu/stats (the JAX
    package's).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch


def default_stats_dir() -> str:
    return os.environ.get("NFDPM_TPU_STATS_DIR",
                          os.path.join(os.path.expanduser("~"), ".nfdpm_tpu", "stats"))


# ---------------------------------------------------------------------------
# Resizing (clean-fid mode semantics)
# ---------------------------------------------------------------------------

def resize_batch(images: np.ndarray, size: int, mode: str, device=None) -> torch.Tensor:
    """uint8 [N, H, W, C] on the host -> float32 [N, size, size, C] in
    [0, 255] on `device`, never re-quantised (clean-fid hands the resizer's
    float output straight to the feature net)."""
    if images.shape[1] == size and images.shape[2] == size:
        return torch.from_numpy(np.ascontiguousarray(images)).to(device).float()
    if mode == "clean":
        # clean-fid's make_resizer("PIL", quantize_after=False, "bicubic"):
        # each channel resized as a float32 'F'-mode PIL image
        from PIL import Image

        out = np.empty((len(images), size, size, images.shape[3]), np.float32)
        for i, im in enumerate(images):
            for c in range(im.shape[-1]):
                ch = Image.fromarray(im[..., c].astype(np.float32), mode="F")
                out[i, :, :, c] = np.asarray(ch.resize((size, size), Image.BICUBIC), np.float32)
        return torch.from_numpy(out).to(device)
    if mode == "legacy_tensorflow":
        return tf1_bilinear_resize(torch.from_numpy(np.ascontiguousarray(images)).to(device),
                                   size)
    raise ValueError(f"Unknown resize mode: {mode}")


def tf1_bilinear_resize(images: torch.Tensor, size: int) -> torch.Tensor:
    """TF1 `tf.image.resize_bilinear(align_corners=False)`: the source
    coordinate of output index i is i * in / out, clamped, NOT the half-pixel
    centres of `F.interpolate(align_corners=False)`. [N, H, W, C] -> float32
    [N, size, size, C] on the same device."""
    n, h, w, c = images.shape
    ys = np.arange(size, dtype=np.float64) * (h / size)
    xs = np.arange(size, dtype=np.float64) * (w / size)
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
    dev = images.device

    def idx(a):
        return torch.from_numpy(a).to(dev)

    wy = idx((ys - y0).astype(np.float32))[None, :, None, None]
    wx = idx((xs - x0).astype(np.float32))[None, None, :, None]
    x = images.float()
    rows0, rows1 = x.index_select(1, idx(y0)), x.index_select(1, idx(y1))
    top = rows0.index_select(2, idx(x0)) * (1 - wx) + rows0.index_select(2, idx(x1)) * wx
    bot = rows1.index_select(2, idx(x0)) * (1 - wx) + rows1.index_select(2, idx(x1)) * wx
    return top * (1 - wy) + bot * wy


def _to_rgb(images: np.ndarray) -> np.ndarray:
    if images.shape[-1] == 1:
        return np.repeat(images, 3, axis=-1)
    return images


def extract_features(images: np.ndarray, feature_fn: Callable, size: int, mode: str,
                     batch_size: int = 64, device=None, mesh=None) -> np.ndarray:
    """uint8 [N, H, W, C] on the host -> float32 [N, D] numpy features:
    resize (float, [0, 255]) then `feature_fn` on `device`, batch by batch.

    With a multi-process `mesh` (parallel/mesh.py) every rank resizes and
    runs the net on its rows of each batch and the features are
    all-gathered. With a one-process mesh over several devices
    (`mesh.local_mesh`), `feature_fn` is one net a device and each batch is
    split across them. Either way the features are those of one device, in
    order."""
    from ..parallel import mesh as mesh_m

    feats = []
    for i in range(0, len(images), batch_size):
        chunk = _to_rgb(images[i: i + batch_size])
        with torch.inference_mode():
            if mesh is not None and len(mesh.devices) > 1:
                per = -(-len(chunk) // len(mesh.devices))
                for j, (fn, dev) in enumerate(zip(feature_fn, mesh.devices)):
                    if j * per < len(chunk):
                        part = resize_batch(chunk[j * per:(j + 1) * per], size, mode, dev)
                        feats.append(fn(part).float().cpu().numpy())
                continue
            start, stop = mesh_m.split_rows(mesh, len(chunk))
            resized = resize_batch(chunk[start:stop], size, mode, device)
            out = mesh_m.gather_split_rows(mesh, len(chunk), feature_fn(resized).float())
            feats.append(out.cpu().numpy())
    return np.concatenate(feats, axis=0)


# ---------------------------------------------------------------------------
# Score math (numpy and scipy, as in the JAX package)
# ---------------------------------------------------------------------------

def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Classic FID: |mu1-mu2|^2 + Tr(S1 + S2 - 2 sqrt(S1 S2))."""
    import scipy.linalg

    diff = mu1 - mu2
    # the array alone: scipy 1.18 took away `disp`, and with it the
    # (array, error estimate) pair
    covmean = scipy.linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def feature_stats(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = np.mean(feats, axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def kid_score(feats1: np.ndarray, feats2: np.ndarray, num_subsets: int = 100,
              max_subset_size: int = 1000, seed: int = 0) -> float:
    """Unbiased MMD^2 with the polynomial kernel (x.y/d + 1)^3, averaged
    over `num_subsets` random subsets (clean-fid's KID protocol)."""
    n = feats1.shape[1]
    m = min(min(feats1.shape[0], feats2.shape[0]), max_subset_size)
    rng = np.random.default_rng(seed)
    t = 0.0
    for _ in range(num_subsets):
        x = feats2[rng.choice(feats2.shape[0], m, replace=False)].astype(np.float64)
        y = feats1[rng.choice(feats1.shape[0], m, replace=False)].astype(np.float64)
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.trace(a)) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)


# ---------------------------------------------------------------------------
# Stats store
# ---------------------------------------------------------------------------

def stat_filename(name: str, mode: str, model_name: str, split: str, res: int) -> str:
    """clean-fid naming convention: {name}_{mode}_{split}_{res}(_model).npz"""
    model_tag = "" if model_name == "inception_v3" else f"_{model_name}"
    return f"{name.lower()}_{mode}_{split}_{res}{model_tag}.npz"


def _stats_path(name, mode, model_name, split, res, stats_dir) -> str:
    return os.path.join(stats_dir or default_stats_dir(),
                        stat_filename(name, mode, model_name, split, res))


def save_stats(feats: np.ndarray, name: str, mode: str, model_name: str, split: str,
               res: int, stats_dir: Optional[str] = None) -> str:
    path = _stats_path(name, mode, model_name, split, res, stats_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    mu, sigma = feature_stats(feats)
    np.savez_compressed(path, mu=mu, sigma=sigma, feats=feats.astype(np.float32))
    return path


def load_stats(name: str, mode: str, model_name: str, split: str, res: int,
               stats_dir: Optional[str] = None):
    path = _stats_path(name, mode, model_name, split, res, stats_dir)
    if not os.path.exists(path):
        return None
    with np.load(path) as d:
        return {"mu": d["mu"], "sigma": d["sigma"], "feats": d["feats"]}


def stats_exist(name, mode, model_name, split, res, stats_dir: Optional[str] = None) -> bool:
    return os.path.exists(_stats_path(name, mode, model_name, split, res, stats_dir))


def remove_all_stats(stats_dir: Optional[str] = None) -> None:
    """The `clean` action of the stats command line."""
    stats_dir = stats_dir or default_stats_dir()
    if os.path.isdir(stats_dir):
        for f in os.listdir(stats_dir):
            if f.endswith(".npz"):
                os.remove(os.path.join(stats_dir, f))
