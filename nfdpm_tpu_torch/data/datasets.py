"""Dataset readers: MNIST / CIFAR-10 / ImageNet32-64 / CelebA / synthetic.

The port's own copy of nfdpm_tpu/data/datasets.py (numpy only). Every
dataset is materialized once as a contiguous uint8 [N, H, W, C] array;
batching, augmentation and the move to the device happen in `pipeline.py`.

On-disk formats supported (nothing downloads):
  * MNIST: raw idx files (train-images-idx3-ubyte etc.), parsed directly,
    with an optional digit filter.
  * CIFAR-10: the python pickle batches (cifar-10-batches-py).
  * ImageNet 32/64: the pickled batch files, train = 10 files, val = 1.
  * CelebA: img_align_celeba JPEG dir + list_eval_partition.csv; the
    partition column selects splits 0/1/2 (needs PIL to decode).
  * synthetic: deterministic procedural images, for training and tests when
    no dataset is on disk.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import pickle
import struct
from typing import List, Optional, Sequence

import numpy as np

# FID/KID generation counts per partition.
DATASET_SIZE = {
    "cifar10": {"train": 50000, "test": 10000},
    "celeba": {"train": 20000, "test": 5000},
    "imagenet32": {"train": 50000, "val": 10000},
}


@dataclasses.dataclass
class ArrayDataset:
    """images: uint8 [N, H, W, C]; labels: int64 [N] (zeros if unlabeled)."""

    images: np.ndarray
    labels: np.ndarray
    name: str = ""

    def __len__(self) -> int:
        return len(self.images)


# ---------------------------------------------------------------------------
# MNIST (raw idx)
# ---------------------------------------------------------------------------

def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def _find_idx_file(root: str, stem: str) -> Optional[str]:
    for sub in ("", "MNIST/raw", "raw"):
        for ext in ("", ".gz"):
            p = os.path.join(root, sub, stem + ext)
            if os.path.exists(p):
                return p
    return None


def read_mnist(root: str, split: str, digits: Optional[Sequence[int]] = None) -> ArrayDataset:
    """Parse raw MNIST idx files (single channel); `digits` keeps only those
    labels."""
    prefix = "train" if split == "train" else "t10k"
    img_path = _find_idx_file(root, f"{prefix}-images-idx3-ubyte")
    lbl_path = _find_idx_file(root, f"{prefix}-labels-idx1-ubyte")
    if img_path is None or lbl_path is None:
        raise FileNotFoundError(f"MNIST idx files not found under {root}")
    images = _read_idx(img_path)[..., None]  # [N, 28, 28, 1]
    labels = _read_idx(lbl_path).astype(np.int64)
    if digits is not None:
        mask = np.isin(labels, list(digits))
        images, labels = images[mask], labels[mask]
    return ArrayDataset(images, labels, name="MNIST")


# ---------------------------------------------------------------------------
# CIFAR-10 (python pickle batches)
# ---------------------------------------------------------------------------

def read_cifar10(root: str, split: str) -> ArrayDataset:
    base = os.path.join(root, "cifar10", "cifar-10-batches-py")
    if not os.path.isdir(base):
        base = os.path.join(root, "cifar-10-batches-py")
    if not os.path.isdir(base):
        raise FileNotFoundError(f"CIFAR-10 batches not found under {root}")
    files = (
        [f"data_batch_{i}" for i in range(1, 6)] if split == "train" else ["test_batch"]
    )
    imgs, labels = [], []
    for fn in files:
        with open(os.path.join(base, fn), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs.append(d[b"data"])
        labels.extend(d[b"labels"])
    data = np.vstack(imgs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return ArrayDataset(np.ascontiguousarray(data), np.asarray(labels, np.int64), name="cifar10")


# ---------------------------------------------------------------------------
# ImageNet 32/64 (pickled batch files)
# ---------------------------------------------------------------------------


def _atomic_cache_save(path: str, arr: np.ndarray) -> Optional[np.ndarray]:
    """np.save via temp-file + rename so an interrupted write can never
    leave a truncated cache that poisons every later mmap load; returns the
    reloaded memmap or None when the dir is unwritable."""
    tmp = f"{path}.{os.getpid()}.tmp.npy"  # .npy suffix: np.save keeps it
    try:
        np.save(tmp, arr)
        os.replace(tmp, path)
        return np.load(path, mmap_mode="r")
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def read_imagenet(root: str, split: str, res: int = 32,
                  memmap: Optional[bool] = None) -> ArrayDataset:
    """Layout: root/imagenet{res}/{split}/{split}_data_batch_i.

    The decoded NHWC tensor is cached next to the pickles as one .npy and
    memory-mapped on later loads. ImageNet32-train is 1.28M x 32x32x3 = ~3.7 GB — unpickling ten
    batch files costs minutes and 2x peak RSS every run, while the memmap
    path starts instantly and lets the page cache manage residency . Opt out with
    `memmap=False` or NFDPM_DATA_MEMMAP=0; cache-dir write failures
    fall back to the in-memory path silently."""
    assert res in (32, 64)
    assert split in ("train", "val")
    base = os.path.join(root, f"imagenet{res}")
    use_mmap = (memmap if memmap is not None
                else os.environ.get("NFDPM_DATA_MEMMAP", "1") != "0")
    img_cache = os.path.join(base, f"{split}_nhwc_u8.npy")
    lbl_cache = os.path.join(base, f"{split}_labels_i64.npy")
    if use_mmap and os.path.exists(img_cache) and os.path.exists(lbl_cache):
        try:
            return ArrayDataset(np.load(img_cache, mmap_mode="r"),
                                np.load(lbl_cache), name=f"imagenet{res}")
        except (ValueError, OSError):  # corrupt/truncated cache: re-decode
            pass

    def unpickle(p):
        with open(p, "rb") as f:
            return pickle.load(f)

    if split == "train" and res == 32:
        files = [os.path.join(base, "train", f"train_data_batch_{i}") for i in range(1, 11)]
        data = np.vstack([unpickle(p)["data"] for p in files])
        labels = np.hstack([unpickle(p)["labels"] for p in files])
    else:
        d = unpickle(os.path.join(base, split, f"{split}_data"))
        data, labels = d["data"], np.asarray(d["labels"])
    # flat [N, 3*res*res] channel-planar -> [N, res, res, 3]
    data = np.dstack((data[:, : res ** 2], data[:, res ** 2: 2 * res ** 2], data[:, 2 * res ** 2:]))
    data = np.ascontiguousarray(data.reshape(-1, res, res, 3))
    labels = labels.astype(np.int64)
    if use_mmap:
        mapped = _atomic_cache_save(img_cache, data)
        if mapped is not None and _atomic_cache_save(lbl_cache, labels) is not None:
            data = mapped
    return ArrayDataset(data, labels, name=f"imagenet{res}")


# ---------------------------------------------------------------------------
# CelebA (JPEG dir + partition csv)
# ---------------------------------------------------------------------------

def read_celeba(
    root: str, splits: Sequence[int], img_size: Optional[int] = None,
    limit: Optional[int] = None, memmap: Optional[bool] = None,
) -> ArrayDataset:
    """Partition file: split 0=train, 1=val, 2=test. Images are decoded once (PIL) and, when
    `img_size` is given, resized bilinear to (img_size, img_size) at load so
    the training pipeline stays pure-array.

    Like read_imagenet, the decoded tensor is cached as one .npy and
    memory-mapped on later loads: 162k train JPEGs decode serially in PIL
    (minutes on a small host, ~9 GB at 128x128) but the cache maps
    instantly, keyed by splits/img_size/limit. NFDPM_DATA_MEMMAP=0 or
    memmap=False opts out; unwritable dataset dirs fall back in-memory."""
    import csv

    from PIL import Image

    img_dir = os.path.join(root, "celeba", "img_align_celeba", "img_align_celeba")
    part_csv = os.path.join(root, "celeba", "list_eval_partition.csv")
    if not os.path.exists(part_csv):
        raise FileNotFoundError(f"CelebA partition csv not found: {part_csv}")
    use_mmap = (memmap if memmap is not None
                else os.environ.get("NFDPM_DATA_MEMMAP", "1") != "0")
    key = f"s{''.join(map(str, sorted(splits)))}_r{img_size or 0}_l{limit or 0}"
    img_cache = os.path.join(root, "celeba", f"decoded_{key}_u8.npy")
    if use_mmap and os.path.exists(img_cache):
        try:
            images = np.load(img_cache, mmap_mode="r")
            return ArrayDataset(images, np.zeros((len(images),), np.int64),
                                name="celeba")
        except (ValueError, OSError):  # corrupt/truncated cache: re-decode
            pass
    names: List[str] = []
    with open(part_csv) as f:
        for row in csv.DictReader(f):
            if int(row["partition"]) in splits:
                names.append(row["image_id"])
    if limit is not None:
        names = names[:limit]
    out = []
    for n in names:
        im = Image.open(os.path.join(img_dir, n)).convert("RGB")
        if img_size is not None:
            im = im.resize((img_size, img_size), Image.BILINEAR)
        out.append(np.asarray(im, np.uint8))
    images = np.stack(out) if out else np.zeros((0, img_size or 218, img_size or 178, 3), np.uint8)
    if use_mmap and len(images):
        mapped = _atomic_cache_save(img_cache, images)
        if mapped is not None:
            images = mapped
    return ArrayDataset(images, np.zeros((len(images),), np.int64), name="celeba")


# ---------------------------------------------------------------------------
# Synthetic (procedural, deterministic)
# ---------------------------------------------------------------------------

def synthetic(
    n: int = 512, img_size: int = 32, channels: int = 3, n_classes: int = 10, seed: int = 0
) -> ArrayDataset:
    """Deterministic procedural images: class-conditioned Gaussian blobs +
    sinusoidal textures. Gives non-trivial, learnable structure for smoke
    training when no real dataset is on disk."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n)
    yy, xx = np.mgrid[0:img_size, 0:img_size].astype(np.float32) / img_size
    images = np.empty((n, img_size, img_size, channels), np.uint8)
    for i in range(n):
        c = labels[i]
        cx, cy = 0.3 + 0.05 * (c % 5), 0.3 + 0.08 * (c // 5)
        r = rng.uniform(0.05, 0.2)
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r * r)))
        tex = 0.5 + 0.5 * np.sin(2 * np.pi * (3 + c) * xx + rng.uniform(0, np.pi))
        img = np.stack([blob, tex, 0.5 * blob + 0.5 * tex][:channels], axis=-1)
        img = img + rng.normal(0, 0.03, img.shape)
        images[i] = np.clip(img * 255, 0, 255).astype(np.uint8)
    return ArrayDataset(images, labels.astype(np.int64), name="synthetic")
