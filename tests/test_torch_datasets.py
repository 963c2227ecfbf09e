"""The port's dataset readers against the JAX package's, on the real file formats.

tools/make_synthetic_{mnist,cifar10,imagenet32,celeba}.py write MNIST (gzip
idx), CIFAR-10 (python pickle batches), ImageNet 32 and 64 (pickled batch
files) and CelebA (JPEGs and the partition csv) into a temporary directory,
at small counts. nfdpm_tpu_torch/data/datasets.py's readers, the metrics'
`load_dataset_images` and `read_dataset`'s batches are held against the
JAX package's, array for array (the batches' [0, 1] floats within one ulp,
6e-8, as in tests/test_torch_entry.py). The JAX readers run without their
.npy caches; the port's write theirs and read them back.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from nfdpm_tpu.data import datasets as jdata
from nfdpm_tpu.data import pipeline as jpipe
from nfdpm_tpu.metrics import compute as jcompute
from nfdpm_tpu_torch.data import datasets as tdata
from nfdpm_tpu_torch.data import pipeline as tpipe
from nfdpm_tpu_torch.metrics import compute as tcompute

REPO = Path(__file__).resolve().parents[1]
WRITERS = {
    "mnist": ["--n-train", "40", "--n-test", "24"],
    "cifar10": ["--per-batch", "12", "--n-test", "20"],
    "imagenet32": ["--per-batch", "6", "--n-val", "14"],
    "celeba": ["--n-train", "10", "--n-val", "3", "--n-test", "5"],
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    for name, args in WRITERS.items():
        subprocess.run([sys.executable, str(REPO / "tools" / f"make_synthetic_{name}.py"),
                        "--root", str(root), *args], check=True, capture_output=True,
                       timeout=120)
    subprocess.run([sys.executable, str(REPO / "tools" / "make_synthetic_imagenet32.py"),
                    "--root", str(root), "--res", "64", "--per-batch", "8", "--n-val", "6"],
                   check=True, capture_output=True, timeout=120)
    return str(root)


def _same(ours, ref, n=None):
    """Port's ArrayDataset (read twice: the second time from its cache) and
    the JAX package's: equal images and labels."""
    for got in ours:
        np.testing.assert_array_equal(np.asarray(got.images), ref.images)
        np.testing.assert_array_equal(np.asarray(got.labels), ref.labels)
        assert got.name == ref.name
    if n is not None:
        assert len(ref) == n


@pytest.mark.parametrize("split,digits,n", [("train", None, 40), ("test", None, 24),
                                            ("train", (1, 3), None)])
def test_read_mnist(root, split, digits, n):
    ref = jdata.read_mnist(root, split, digits)
    _same([tdata.read_mnist(root, split, digits)], ref, n)
    assert ref.images.shape[1:] == (28, 28, 1)


@pytest.mark.parametrize("split,n", [("train", 60), ("test", 20)])
def test_read_cifar10(root, split, n):
    ref = jdata.read_cifar10(root, split)
    _same([tdata.read_cifar10(root, split)], ref, n)
    assert ref.images.shape[1:] == (32, 32, 3)


@pytest.mark.parametrize("res,split,n", [(32, "train", 60), (32, "val", 14), (64, "train", 8),
                                         (64, "val", 6)])
def test_read_imagenet(root, res, split, n):
    ref = jdata.read_imagenet(root, split, res, memmap=False)
    ours = [tdata.read_imagenet(root, split, res, memmap=True) for _ in range(2)]
    _same(ours, ref, n)
    assert ref.images.shape[1:] == (res, res, 3)


@pytest.mark.parametrize("splits,img_size,limit,n", [([0], 32, None, 10), ([2], None, None, 5),
                                                      ([0, 1], 16, 7, 7)])
def test_read_celeba(root, splits, img_size, limit, n):
    ref = jdata.read_celeba(root, splits, img_size=img_size, limit=limit, memmap=False)
    ours = [tdata.read_celeba(root, splits, img_size=img_size, limit=limit, memmap=True)
            for _ in range(2)]
    _same(ours, ref, n)


@pytest.mark.parametrize("name,split,res,limit", [
    ("MNIST", "train", 32, None), ("cifar10", "test", 32, 9), ("imagenet32", "train", 32, None),
    ("imagenet64", "val", 64, None), ("celeba", "train", 224, 4), ("celeba", "test", 224, None),
    ("synthetic", "train", 16, 12)])
def test_load_dataset_images(root, monkeypatch, name, split, res, limit):
    monkeypatch.setenv("NFDPM_DATA_MEMMAP", "0")  # each package decodes the files itself
    ref = jcompute.load_dataset_images(name, root, split, res, limit)
    np.testing.assert_array_equal(tcompute.load_dataset_images(name, root, split, res, limit),
                                  ref)


@pytest.mark.parametrize("name,img_size,transformations", [
    ("MNIST", 32, []), ("cifar10", 32, ["RandomHorizontalFlip"]), ("imagenet32", 32, []),
    ("celeba", 16, ["RandomHorizontalFlip"])])
def test_read_dataset_batches(root, monkeypatch, name, img_size, transformations):
    monkeypatch.setenv("NFDPM_DATA_MEMMAP", "0")
    kw = dict(batch_size=4, img_size=img_size, transformations=transformations, seed=3)
    ref, ours = jpipe.read_dataset(name, root, **kw), tpipe.read_dataset(name, root, **kw)
    for split in ("train", "test", "eval"):
        a, b = getattr(ref, split), getattr(ours, split)
        assert len(a) == len(b) > 0
        for (ia, la), (ib, lb) in zip(a.iter_epoch(1), b.iter_epoch(1)):
            # the JAX package's native gather multiplies by 1/255 where the
            # port divides by 255: one ulp of a value below 1
            np.testing.assert_allclose(ib, ia, rtol=0, atol=6e-8)
            np.testing.assert_array_equal(lb, la)
