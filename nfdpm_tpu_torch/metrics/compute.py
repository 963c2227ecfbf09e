"""Metrics orchestration: evaluate_model, sampler caching, stats precompute.

Counterpart of nfdpm_tpu/metrics/compute.py:

  * `Storage` caches generated images, so that one generation pass serves
    every metric configuration.
  * `evaluate_model` runs the FID configurations, then KID's, then
    SSIM/PSNR, marking the cache ready after the first metric.
  * CelebA generations are resized to 224 (PIL bilinear) before caching.
  * `precompute_statistics` computes and stores a dataset's stats unless
    they exist; `make_custom_stats` does the work.
  * `make_nf_evaluate_fn` is the trainers' `evaluate_fn` hook.

Feature nets: `get_feature_extractor` loads the real weights from
NFDPM_TPU_WEIGHTS_DIR (default ~/.nfdpm_tpu/weights; file names
inception.WEIGHTS_FILE and clip_features.WEIGHTS_FILE) and, when a file is
absent, logs a warning that names it and uses the seeded random network.
Every function that runs a feature net takes a `device`: CUDA unless the
caller names another, and without CUDA it raises.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import in_full_fp32, resolve_device
from ..data.datasets import DATASET_SIZE
from . import clip_features, inception
from . import fid as fid_m
from .image_quality import psnr as psnr_fn
from .image_quality import ssim as ssim_fn

_log = logging.getLogger(__name__)

# model name -> feature function; tests put their own functions here
_EXTRACTOR_CACHE: Dict[str, Callable] = {}

FEATURE_RES = {"inception_v3": 299, "clip_vit_b_32": 224}
_FEATURE_NETS = {"inception_v3": inception, "clip_vit_b_32": clip_features}


def weights_dir() -> str:
    return os.environ.get("NFDPM_TPU_WEIGHTS_DIR",
                          os.path.join(os.path.expanduser("~"), ".nfdpm_tpu", "weights"))


def get_feature_extractor(model_name: str, device=None) -> Callable:
    """float [B, res, res, 3] in [0, 255] -> [B, D] features on `device`;
    built once per model name."""
    if model_name in _EXTRACTOR_CACHE:
        return _EXTRACTOR_CACHE[model_name]
    if model_name not in _FEATURE_NETS:
        raise ValueError(f"Unknown feature model: {model_name}")
    net = _FEATURE_NETS[model_name]
    path = os.path.join(weights_dir(), net.WEIGHTS_FILE)
    if os.path.exists(path):
        model = net.load_weights(path)
    else:
        _log.warning(f"{path} not found: {model_name} features come from seeded random "
                     "weights, so FID/KID values are not comparable with clean-fid's")
        model = net.random_init(0)
    fn = net.make_feature_fn(model, resolve_device(device))
    _EXTRACTOR_CACHE[model_name] = fn
    return fn


# ---------------------------------------------------------------------------
# Generated-sample cache
# ---------------------------------------------------------------------------

class Storage:
    def __init__(self):
        self.data: Optional[np.ndarray] = None
        self.ready = False
        self.index = 0

    def reset(self):
        self.data, self.ready, self.index = None, False, 0

    def set_ready_for_usage(self):
        self.ready, self.index = True, 0

    def append(self, samples: np.ndarray):
        self.data = samples if self.data is None else np.concatenate([self.data, samples])

    def take(self, n: int) -> np.ndarray:
        out = self.data[self.index: self.index + n]
        self.index += n
        return out


def make_cached_sampler(sample_images: Callable[[int], np.ndarray]) -> Callable:
    """Wraps a raw `n -> uint8 [n, H, W, C]` sampler with Storage caching;
    the storage is the returned function's `storage`."""
    storage = Storage()

    def gen(n: int) -> np.ndarray:
        if storage.ready:
            return storage.take(n)
        out = np.asarray(sample_images(n))
        storage.append(out)
        return out

    gen.storage = storage
    return gen


# ---------------------------------------------------------------------------
# Dataset images for stats
# ---------------------------------------------------------------------------

def load_dataset_images(data_name: str, data_root: str, split: str, res: int,
                        limit: Optional[int] = None) -> np.ndarray:
    """uint8 [N, H, W, C] source images of a dataset split, through the
    port's readers."""
    from ..data import datasets as ds

    if data_name == "cifar10":
        d = ds.read_cifar10(data_root, "train" if split == "train" else "test")
    elif data_name == "MNIST":
        d = ds.read_mnist(data_root, split)
    elif data_name in ("imagenet32", "imagenet64"):
        r = int(data_name.replace("imagenet", ""))
        d = ds.read_imagenet(data_root, "train" if split == "train" else "val", r)
    elif data_name == "celeba":
        d = ds.read_celeba(data_root, [0] if split == "train" else [2], img_size=res,
                           limit=limit)
    elif data_name == "synthetic":
        d = ds.synthetic(limit or 512, res, 3)
    else:
        raise ValueError(f"Unknown dataset: {data_name}")
    imgs = d.images
    if limit is not None:
        imgs = imgs[:limit]
    return imgs


# ---------------------------------------------------------------------------
# Stats precompute
# ---------------------------------------------------------------------------

def feature_extractor_for(model_name: str, device, mesh=None):
    """The feature net on `device`; for a one-process mesh over several
    devices, one replica a device (fid.extract_features' `feature_fn`)."""
    if mesh is not None and len(mesh.devices) > 1:
        return [get_feature_extractor(model_name, d) for d in mesh.devices]
    return get_feature_extractor(model_name, device)


def make_custom_stats(logger, data_root: str, data_name: str, split: str, res: int,
                      mode: str, model_name: str, batch_size: int = 64,
                      stats_dir: Optional[str] = None, limit: Optional[int] = None,
                      device=None, mesh=None) -> str:
    """The stats file of a dataset split; with a `mesh`, the feature net
    runs data-parallel (fid.extract_features) and rank 0 writes."""
    device = resolve_device(device)
    feature_fn = feature_extractor_for(model_name, device, mesh)
    images = load_dataset_images(data_name, data_root, split, res, limit)
    feats = fid_m.extract_features(images, feature_fn, FEATURE_RES[model_name], mode,
                                   batch_size, device, mesh)
    if mesh is not None and mesh.rank != 0:
        return fid_m._stats_path(data_name, mode, model_name, split, res, stats_dir)
    path = fid_m.save_stats(feats, data_name, mode, model_name, split, res, stats_dir)
    if logger:
        logger.info(f"Saved stats ({len(feats)} samples) to {path}")
    return path


def precompute_statistics(logger, data_root: str, data_name: str, dataset_split: str,
                          dataset_res: int, mode: str, model_name: str,
                          stats_dir: Optional[str] = None, limit: Optional[int] = None,
                          device=None, mesh=None) -> None:
    """Computes and stores the stats unless the file exists (the feature net
    data-parallel over `mesh`, when given)."""
    if fid_m.stats_exist(data_name, mode, model_name, dataset_split, dataset_res, stats_dir):
        if logger:
            logger.info("Precomputed stats already exist for the dataset.")
        return
    make_custom_stats(logger, data_root, data_name, dataset_split, dataset_res, mode,
                      model_name, stats_dir=stats_dir, limit=limit, device=device, mesh=mesh)


# ---------------------------------------------------------------------------
# FID / KID against stored stats
# ---------------------------------------------------------------------------

def calculate_fid_kid(gen: Callable[[int], np.ndarray], data_name: str, dataset_res: int,
                      num_gen: int, dataset_split: str, batch_size: int, score_type: str,
                      mode: str, model_name: str = "inception_v3",
                      stats_dir: Optional[str] = None, gen_batch_size: Optional[int] = None,
                      device=None, mesh=None) -> float:
    """`gen_batch_size` (default batch_size) images per sampler call;
    `batch_size` images per feature-net call (data-parallel over `mesh`)."""
    device = resolve_device(device)
    gen_batch_size = gen_batch_size or batch_size
    dataset_res = 224 if data_name == "celeba" else dataset_res
    stats = fid_m.load_stats(data_name, mode, model_name, dataset_split, dataset_res,
                             stats_dir)
    if stats is None:
        raise FileNotFoundError(
            f"No precomputed stats for {data_name}/{mode}/{model_name}/"
            f"{dataset_split}/{dataset_res}; run precompute_statistics first.")
    feature_fn = feature_extractor_for(model_name, device, mesh)
    feats = []
    remaining = num_gen
    while remaining > 0:
        n = min(gen_batch_size, remaining)
        feats.append(fid_m.extract_features(gen(n), feature_fn, FEATURE_RES[model_name], mode,
                                            batch_size, device, mesh))
        remaining -= n
    gen_feats = np.concatenate(feats)

    if score_type == "FID":
        mu_g, sigma_g = fid_m.feature_stats(gen_feats)
        return fid_m.frechet_distance(stats["mu"], stats["sigma"], mu_g, sigma_g)
    if score_type == "KID":
        return fid_m.kid_score(stats["feats"], gen_feats)
    raise ValueError(f"Unknown score type {score_type}.")


def metric_key(score_type: str, mode: str, model_name: str) -> str:
    """The JAX package's key: e.g. FID_inception, KID_clean_clip."""
    return f"{score_type}{'_clean' if mode == 'clean' else ''}_{model_name.split('_')[0]}"


# ---------------------------------------------------------------------------
# evaluate_model
# ---------------------------------------------------------------------------

@in_full_fp32
def evaluate_model(*, sample_images: Callable[[int], np.ndarray], data_name: str,
                   dataset_res: int, batch_size: int, num_gen: int, dataset_split: str,
                   fid_kwargs: Optional[List[Dict]] = None,
                   kid_kwargs: Optional[List[Dict]] = None,
                   ssim_psnr_kwargs: Optional[Dict] = None, stats_dir: Optional[str] = None,
                   logger=None, gen_batch_size: Optional[int] = None,
                   device=None, mesh=None) -> Dict[str, Any]:
    """One generation pass (uint8 numpy images from `sample_images(n)`)
    serves every requested metric through Storage, with TF32 off (the
    switches restored after it, so a run at matmul_precision="high" trains
    on in TF32)."""
    device = resolve_device(device)
    metrics: Dict[str, Any] = {}
    if data_name == "celeba":
        # CelebA generations are resized to 224 before caching, so CLIP and
        # Inception both see the 224 images
        raw_sampler = sample_images

        def sample_images(n):  # noqa: F811
            return _bilinear_resize_uint8(np.asarray(raw_sampler(n)), 224)

    gen = make_cached_sampler(sample_images)

    for score_type, configs in (("FID", fid_kwargs), ("KID", kid_kwargs)):
        for kwarg in configs or []:
            mode, model_name = kwarg["mode"], kwarg["model_name"]
            key = metric_key(score_type, mode, model_name)
            metrics[key] = calculate_fid_kid(
                gen, data_name, dataset_res, num_gen, dataset_split, batch_size, score_type,
                mode, model_name, stats_dir, gen_batch_size, device, mesh)
            gen.storage.set_ready_for_usage()
            if logger:
                logger.info(f"{key}: {metrics[key]:.4f}")

    if ssim_psnr_kwargs:
        data_range = float(ssim_psnr_kwargs.get("data_range", 255))
        ssim_vals, psnr_vals = [], []
        n_used, n_total = 0, 0
        for imgs, _labels in ssim_psnr_kwargs["loader"]:
            n_total += len(imgs)
            target = np.asarray(gen(len(imgs)), np.float32)
            if len(target) < len(imgs):
                break  # the generated cache ran short; reported below
            n_used += len(imgs)
            # real images truncated to uint8 first, as the reference's `discretize`
            real = (imgs * 255).astype(np.uint8).astype(np.float32)
            if real.shape[-1] == 1:
                real = np.repeat(real, target.shape[-1] // real.shape[-1], axis=-1)
            pred, real = torch.from_numpy(target).to(device), torch.from_numpy(real).to(device)
            ssim_vals.append(float(ssim_fn(pred, real, data_range)))
            psnr_vals.append(float(psnr_fn(pred, real, data_range)))
        if logger and n_used < n_total:
            logger.warning(
                f"SSIM/PSNR covered only {n_used}/{n_total} eval images "
                f"(generated cache holds {num_gen}); raise num_gen for full coverage.")
        metrics["SSIM"] = float(np.mean(ssim_vals)) if ssim_vals else float("nan")
        metrics["PSNR"] = float(np.mean(psnr_vals)) if psnr_vals else float("nan")
        gen.storage.set_ready_for_usage()

    gen.storage.reset()
    return metrics


def _bilinear_resize_uint8(images: np.ndarray, size: int) -> np.ndarray:
    """torchvision T.Resize(size) semantics (PIL bilinear) on uint8 NHWC."""
    from PIL import Image

    if images.shape[1] == size and images.shape[2] == size:
        return images
    out = np.empty((len(images), size, size, images.shape[3]), np.uint8)
    for i, im in enumerate(images):
        arr = im[..., 0] if im.shape[-1] == 1 else im
        r = np.asarray(Image.fromarray(arr).resize((size, size), Image.BILINEAR))
        out[i] = r[..., None] if im.shape[-1] == 1 else r
    return out


# ---------------------------------------------------------------------------
# Trainer hook
# ---------------------------------------------------------------------------

def make_nf_evaluate_fn(*, data_name: str, loaders, fid_configs: List[Dict],
                        kid_configs: List[Dict], img_size: int, temperature: float, logger,
                        stats_dir: Optional[str] = None, quick_num_gen: int = 64,
                        ssim_psnr: Optional[Dict] = None, dataset_split: str = "train",
                        gen_batch_size: int = 256, device=None, mesh=None):
    """evaluate_fn(sample_fn, params, epoch, full=False) for both trainers,
    with sample_fn(params, n, temperature, salt) -> uint8 [n, H, W, C] on
    the device: `quick_num_gen` images at checkpoint epochs, the dataset's
    DATASET_SIZE count with `full=True` (the final evaluation and
    phase=eval). A missing stats file gives a warning and {}. Under a
    data-parallel `mesh` the sampler gathers every rank's rows and the
    feature nets run on each rank's rows of the images."""
    device = resolve_device(device)
    split = dataset_split
    if data_name == "imagenet32" and split == "test":
        split = "val"  # imagenet32 has no test split

    def evaluate_fn(sample_fn, params, epoch, full: bool = False):
        num_gen = (DATASET_SIZE.get(data_name, {}).get(split, quick_num_gen)
                   if full else quick_num_gen)
        # a running counter in the salt: every sampler call of one
        # evaluation draws fresh images
        call_counter = [0]

        def sample_images(n):
            salt = epoch * 100_003 + call_counter[0]
            call_counter[0] += 1
            return sample_fn(params, n, temperature, salt).cpu().numpy()

        ssim_kwargs = None
        if ssim_psnr is not None:
            ssim_kwargs = {"data_range": ssim_psnr.get("data_range", 255),
                           "loader": loaders.eval}
        try:
            metrics = evaluate_model(
                sample_images=sample_images, data_name=data_name, dataset_res=img_size,
                batch_size=32, num_gen=num_gen, dataset_split=split, fid_kwargs=fid_configs,
                kid_kwargs=kid_configs, ssim_psnr_kwargs=ssim_kwargs, stats_dir=stats_dir,
                logger=logger, gen_batch_size=max(gen_batch_size, 32), device=device,
                mesh=mesh)
            logger.info(f"epoch {epoch} metrics: {metrics}")
            return metrics
        except FileNotFoundError as e:
            logger.warning(f"Skipping FID/KID (no precomputed stats): {e}")
            return {}

    return evaluate_fn
