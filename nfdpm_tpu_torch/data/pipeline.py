"""Batch pipeline: transforms, splits, the four-loader contract, and the
move of batches to the device.

The port's own copy of nfdpm_tpu/data/pipeline.py (numpy on the host):

  * `read_dataset(...)` returns four loaders: train (augmented, shuffled),
    val (optional stratified 80/20 split), test, and "eval" (train data
    under the test transforms, shuffled).
  * Train batches have one shape (drop_last=True); eval loaders pad the
    final partial batch and report the valid count.
  * Transforms (ToTensor semantics, MNIST pad-to-32 else resize, optional
    RandomHorizontalFlip) are whole-batch array ops; the flip draws from a
    seeded numpy Generator.
  * `host_shard` is a data-parallel rank's slice of a global batch.
  * A batch is assembled (gather, [0, 1], flip) in one multithreaded C++
    pass, or its numpy path where no compiler is found (native.py).
  * `prefetch_to_device` assembles the batches and copies them to the
    device on a producer thread, two batches ahead of the step that uses
    them (pinned host memory, non-blocking copies).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.profiling import annotate, count
from . import native
from .datasets import (
    ArrayDataset,
    read_celeba,
    read_cifar10,
    read_imagenet,
    read_mnist,
    synthetic,
)

Batch = Tuple[np.ndarray, np.ndarray]  # images fp32 [B,H,W,C] in [0,1], labels


# ---------------------------------------------------------------------------
# Whole-array transforms (torchvision semantics, vectorized)
# ---------------------------------------------------------------------------

def pad_to(images: np.ndarray, size: int) -> np.ndarray:
    """Center zero-pad H,W to `size` (the MNIST 28->32 path)."""
    h, w = images.shape[1], images.shape[2]
    ph, pw = (size - h) // 2, (size - w) // 2
    return np.pad(images, ((0, 0), (ph, size - h - ph), (pw, size - w - pw), (0, 0)))


def resize(images: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize to (size, size) (torchvision Resize semantics)."""
    if images.shape[1] == size and images.shape[2] == size:
        return images
    from PIL import Image

    out = np.empty((len(images), size, size, images.shape[3]), images.dtype)
    for i, im in enumerate(images):
        arr = im[..., 0] if im.shape[-1] == 1 else im
        pil = Image.fromarray(arr)
        r = np.asarray(pil.resize((size, size), Image.BILINEAR))
        out[i] = r[..., None] if im.shape[-1] == 1 else r
    return out


def apply_static_transform(ds: ArrayDataset, data_name: str, img_size: int,
                           train: bool = True) -> ArrayDataset:
    """The deterministic part of the transforms: the TRAIN transform pads
    MNIST to img_size when > 28 while the TEST transform is always a
    bilinear resize, so MNIST trains on padded digits and evaluates on
    resized ones (the eval loader is train data under the test transform)."""
    if train and data_name == "MNIST" and img_size > ds.images.shape[1]:
        images = pad_to(ds.images, img_size)
    elif img_size != ds.images.shape[1]:
        images = resize(ds.images, img_size)
    else:
        images = ds.images
    return ArrayDataset(images, ds.labels, ds.name)


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Loader:
    """Deterministic, restartable batch iterator over an ArrayDataset."""

    dataset: ArrayDataset
    batch_size: int
    shuffle: bool = False
    drop_last: bool = False
    random_hflip: bool = False
    seed: int = 0
    _epoch: int = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)

    @property
    def num_samples(self) -> int:
        return len(self.dataset)

    def __iter__(self) -> Iterator[Batch]:
        e = self._epoch
        self._epoch += 1
        return self.iter_epoch(e)

    def iter_epoch(self, epoch: int, start_batch: int = 0) -> Iterator[Batch]:
        """One epoch's batches as a PURE function of (seed, epoch): shuffle
        order and hflip draws depend on nothing but the arguments, so a
        resumed run replays the exact data stream of an uninterrupted one
        (the trainers pass their absolute epoch number here; plain
        `iter(loader)` keeps an internal counter for ad-hoc consumers).

        `start_batch` skips the first N batches for mid-epoch resume —
        the skipped batches' hflip draws are still consumed so batch N
        onward is bit-identical to the full epoch, while the gather and
        normalize work is skipped for them. A batch is assembled in one
        pass (gather, ToTensor's [0, 1] map, flip) by native.py, the C++
        library or its numpy path, which give the same bits."""
        n = len(self.dataset)
        idx = np.arange(n)
        rng = np.random.default_rng(self.seed + epoch)
        if self.shuffle:
            rng.shuffle(idx)
        bs = self.batch_size
        n_batches = len(self)
        for b in range(n_batches):
            sel = idx[b * bs: (b + 1) * bs]
            flips = (
                (rng.random(len(sel)) < 0.5).astype(np.uint8)
                if self.random_hflip else None
            )
            if b < start_batch:
                continue
            yield native.batch_gather_normalize(self.dataset.images, sel, flips), \
                self.dataset.labels[sel]

    def padded_batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        """One-shape eval iteration: the final partial batch is zero-padded;
        yields (images, labels, n_valid)."""
        for imgs, labels in self:
            n_valid = len(imgs)
            if n_valid < self.batch_size:
                pad = self.batch_size - n_valid
                imgs = np.concatenate([imgs, np.zeros((pad,) + imgs.shape[1:], imgs.dtype)])
                labels = np.concatenate([labels, np.zeros((pad,), labels.dtype)])
            yield imgs, labels, n_valid


def stratified_split(
    labels: np.ndarray, test_frac: float = 0.2, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class 80/20 index split (sklearn train_test_split(stratify=labels)
    semantics) without the sklearn dependency."""
    rng = np.random.default_rng(seed)
    train_idx, val_idx = [], []
    for c in np.unique(labels):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        k = int(round(len(idx) * test_frac))
        val_idx.append(idx[:k])
        train_idx.append(idx[k:])
    return np.concatenate(train_idx), np.concatenate(val_idx)


@dataclasses.dataclass
class DatasetLoaders:
    train: Loader
    val: Optional[Loader]
    test: Loader
    eval: Loader  # train data, test transforms, shuffled


def read_dataset(
    data_name: str,
    root: str,
    validate: bool = False,
    digits: Optional[Sequence[int]] = None,
    batch_size: int = 64,
    img_size: int = 32,
    transformations: Optional[List[str]] = None,
    seed: int = 0,
    synthetic_fallback: bool = False,
    synthetic_n: int = 512,
) -> DatasetLoaders:
    """The four loaders of a dataset. `synthetic_fallback=True` substitutes
    procedural data when the on-disk dataset is missing; `data_name` =
    "synthetic" always takes it."""
    transformations = transformations or []
    hflip = "RandomHorizontalFlip" in transformations

    def load(split: str) -> ArrayDataset:
        try:
            if data_name == "MNIST":
                return read_mnist(root, split, digits)
            if data_name == "cifar10":
                return read_cifar10(root, split)
            if data_name in ("imagenet32", "imagenet64"):
                res = int(data_name.replace("imagenet", ""))
                return read_imagenet(root, "train" if split == "train" else "val", res)
            if data_name == "celeba":
                return read_celeba(root, [0] if split == "train" else [2], img_size)
            if data_name == "synthetic":
                raise FileNotFoundError
            raise ValueError(f"Unknown dataset name: {data_name}")
        except FileNotFoundError:
            if not synthetic_fallback and data_name != "synthetic":
                raise
            chans = 1 if data_name == "MNIST" else 3
            n = synthetic_n if split == "train" else max(synthetic_n // 4, batch_size)
            return synthetic(n, img_size, chans, seed=0 if split == "train" else 1)

    train_split = load("train")
    train_raw = apply_static_transform(train_split, data_name, img_size, train=True)
    # the "eval" loader is train DATA under the TEST transform: for MNIST
    # that means resize, not pad
    eval_raw = apply_static_transform(train_split, data_name, img_size, train=False)
    test_ds = apply_static_transform(load("test"), data_name, img_size, train=False)

    if validate:
        tr_idx, va_idx = stratified_split(train_raw.labels, 0.2, seed)
        train_ds = ArrayDataset(train_raw.images[tr_idx], train_raw.labels[tr_idx], train_raw.name)
        val_ds = ArrayDataset(train_raw.images[va_idx], train_raw.labels[va_idx], train_raw.name)
        val_loader = Loader(val_ds, batch_size, shuffle=False, seed=seed)
    else:
        train_ds, val_loader = train_raw, None

    return DatasetLoaders(
        train=Loader(train_ds, batch_size, shuffle=True, drop_last=True, random_hflip=hflip, seed=seed),
        val=val_loader,
        test=Loader(test_ds, batch_size, shuffle=False, seed=seed),
        eval=Loader(eval_raw, batch_size, shuffle=True, seed=seed + 1),
    )


# ---------------------------------------------------------------------------
# Data-parallel host sharding
# ---------------------------------------------------------------------------

def host_shard(batch, host_id: int, n_hosts: int):
    """Deterministic per-host slice of the global batch (the JAX package's
    host_shard: equal contiguous slices, the remainder dropped)."""
    per = len(batch) // n_hosts
    return batch[host_id * per: (host_id + 1) * per]


# ---------------------------------------------------------------------------
# Host -> device on a producer thread
# ---------------------------------------------------------------------------

class _Failure:
    """What the producer raised, carried through the queue."""

    def __init__(self, error: BaseException):
        self.error = error


_END = object()
JOIN_TIMEOUT_S = 5.0  # prefetch_to_device's wait for its producer to stop


def _take(q):
    """The next item of queue `q`, waited for in bounded waits, so that an
    interrupt (the watchdog's) lands."""
    import queue

    while True:
        try:
            return q.get(timeout=0.05)
        except queue.Empty:
            continue


def prefetch_to_device(iterator, device: torch.device, size: int = 2):
    """Yield (images on `device`, labels, ...) for each (images, labels, ...)
    of `iterator`, made on a background producer thread that runs
    `iterator` (the batch assembly, the host sharding) and the copy up to
    `size` batches ahead of the consumer, as the JAX package's
    prefetch_to_device does. For a CUDA device the thread works on the
    consumer's device and copies through pinned host memory,
    non-blocking, on the consumer's current stream, so the copy is ordered
    before any work the consumer enqueues after taking the batch (the
    caching host allocator keeps a pinned block until its copy has run);
    for the CPU it is a plain conversion.

    An exception from `iterator` (a KeyboardInterrupt among them) is raised
    after every batch it gave before it has been handed out. When the
    consumer stops (the generator is closed, or an exception leaves it) the
    thread is stopped and joined. Only a thread stuck inside `iterator` (a
    stalled loader, the watchdog's case) is not waited for past
    JOIN_TIMEOUT_S: it stops, doing nothing more, when its iterator gives
    the next batch.

    Spans: the producer's `loader.assemble` (the iterator's batch) and
    `loader.copy` (pinned, non-blocking), the consumer's `loader.wait`
    (blocked on an empty queue); counters `loader.batches` (handed to the
    queue) and `loader.empty_takes` (takes that found it empty)."""
    import queue
    import threading

    cuda = device.type == "cuda"
    if cuda:
        index = device.index if device.index is not None else torch.cuda.current_device()
        stream = torch.cuda.current_stream(index)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def to_device(item):
        imgs = torch.from_numpy(np.ascontiguousarray(item[0], np.float32))
        if cuda:
            with torch.cuda.stream(stream):
                imgs = imgs.pin_memory().to(torch.device("cuda", index), non_blocking=True)
        return (imgs,) + tuple(item[1:])

    def producer():
        try:
            if cuda:
                torch.cuda.set_device(index)
            items = iter(iterator)
            while True:
                with annotate("loader.assemble"):
                    item = next(items, _END)
                if item is _END:
                    break
                with annotate("loader.copy"):
                    item = to_device(item)
                if stop.is_set() or not put(item):
                    return
                count("loader.batches")
            put(_END)
        except BaseException as e:  # noqa: B036 -- handed to the consumer
            put(_Failure(e))

    thread = threading.Thread(target=producer, name="prefetch_to_device", daemon=True)
    thread.start()
    try:
        while True:
            try:
                item = q.get_nowait()
            except queue.Empty:
                count("loader.empty_takes")
                with annotate("loader.wait"):
                    item = _take(q)
            if item is _END:
                return
            if isinstance(item, _Failure):
                raise item.error
            yield item
    finally:
        stop.set()
        thread.join(JOIN_TIMEOUT_S)
        if thread.is_alive():  # inside a stalled `iterator`: it ends at its next batch
            logging.getLogger(__name__).warning(
                f"prefetch_to_device: the producer is still inside its iterator after "
                f"{JOIN_TIMEOUT_S} s; it stops at the iterator's next batch")
