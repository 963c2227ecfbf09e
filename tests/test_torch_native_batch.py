"""The port's batch assembly and its producer thread on the CPU
(nfdpm_tpu_torch/data/native.py, csrc/batch_ops.cpp, data/pipeline.py).

  * The native library, built with this host's g++ into build/native/,
    against the port's numpy path and against the JAX package's
    batch_gather_normalize (its C++ library, built by `make -C native`):
    bitwise, with and without flips, at odd batch sizes, on one thread and
    on every hardware thread (n_threads 1 and 0); the loader's batches on
    both paths bitwise equal, and equal to the JAX package's loader.
  * prefetch_to_device's producer thread: the batches in order; every
    batch given before a failure handed out, then the failure (a
    KeyboardInterrupt, a ValueError) raised; no live thread after a
    failure, after the end, or after the consumer stops early.
  * A two-epoch train (Glow L2/K1, width 16, 8x8x3, batch 8, flips)
    interrupted in its second epoch and resumed there: bitwise equal to
    the uninterrupted run, and no producer thread left.
"""

import logging
import threading

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread
from nfdpm_tpu.data import native as jnative
from nfdpm_tpu.data import pipeline as jpipe
from nfdpm_tpu_torch import convert
from nfdpm_tpu_torch.data import native as tnative
from nfdpm_tpu_torch.data import pipeline as tpipe
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.training import checkpoint as tckpt
from nfdpm_tpu_torch.training import nf_trainer as tnft


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _producers():
    return [t for t in threading.enumerate() if t.name == "prefetch_to_device"]


def test_the_library_builds_and_loads():
    tnative.build()
    assert tnative.LIBRARY.exists()
    assert tnative.available()
    assert jnative.available(), "the JAX package's library (make -C native) did not build"


@pytest.mark.parametrize("n_threads", [1, 0])
@pytest.mark.parametrize("with_flips", [False, True])
@pytest.mark.parametrize("batch", [1, 7, 33])
def test_native_equals_numpy_and_the_jax_package_bitwise(batch, with_flips, n_threads):
    rng = np.random.default_rng(batch)
    images = rng.integers(0, 256, (50, 5, 7, 3)).astype(np.uint8)
    idx = rng.integers(0, 50, batch).astype(np.int64)
    flips = (rng.random(batch) < 0.5).astype(np.uint8) if with_flips else None
    got = tnative.batch_gather_normalize(images, idx, flips, n_threads, native=True)
    plain = tnative.batch_gather_normalize(images, idx, flips, native=False)
    theirs = jnative.batch_gather_normalize(images, idx, flips, n_threads)
    assert got.dtype == np.float32 and got.shape == (batch, 5, 7, 3)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, theirs)
    want = images[idx] * np.float32(1 / 255)
    if with_flips:
        want[flips == 1] = want[flips == 1][:, :, ::-1]
    np.testing.assert_array_equal(got, want)


def test_native_refuses_indices_outside_the_images():
    images = np.zeros((4, 2, 2, 1), np.uint8)
    with pytest.raises(IndexError):
        tnative.batch_gather_normalize(images, np.array([0, 4]), native=True)


@pytest.mark.parametrize("hflip", [False, True])
def test_loader_batches_equal_on_both_paths_and_the_jax_loader(monkeypatch, hflip):
    kw = dict(batch_size=8, img_size=8, seed=3, synthetic_n=40,
              transformations=["RandomHorizontalFlip"] if hflip else [])
    ours, theirs = tpipe.read_dataset("synthetic", "", **kw), jpipe.read_dataset("synthetic", "",
                                                                                 **kw)
    native = list(ours.train.iter_epoch(2, 1))
    gather = tnative.batch_gather_normalize
    monkeypatch.setattr(tnative, "batch_gather_normalize",
                        lambda images, sel, flips: gather(images, sel, flips, native=False))
    plain = list(ours.train.iter_epoch(2, 1))
    jax_batches = list(theirs.train.iter_epoch(2, 1))
    assert len(native) == len(plain) == len(jax_batches) == 4
    for (a, la), (b, lb), (c, lc) in zip(native, plain, jax_batches):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(la, lc)


def _batches(n, failure=None):
    for i in range(n):
        yield np.full((2, 3), i, np.float32), np.array([i])
    if failure is not None:
        raise failure


@pytest.mark.parametrize("size", [1, 2, 4])
def test_producer_keeps_the_order(size):
    got = [(int(x[0, 0]), int(y[0])) for x, y in
           tpipe.prefetch_to_device(_batches(9), torch.device("cpu"), size)]
    assert got == [(i, i) for i in range(9)]
    assert not _producers()


@pytest.mark.parametrize("failure", [KeyboardInterrupt, ValueError])
def test_producer_hands_out_every_batch_then_raises(failure):
    got = []
    with pytest.raises(failure):
        for x, _ in tpipe.prefetch_to_device(_batches(5, failure("stop")), torch.device("cpu")):
            got.append(int(x[0, 0]))
    assert got == [0, 1, 2, 3, 4]
    assert not _producers()


def test_producer_stops_when_the_consumer_stops():
    batches = tpipe.prefetch_to_device(_batches(100), torch.device("cpu"))
    first = next(batches)
    assert int(first[0][0, 0]) == 0 and _producers()
    batches.close()
    assert not _producers()
    with pytest.raises(RuntimeError):  # an exception in the consumer's step
        for x, _ in tpipe.prefetch_to_device(_batches(100), torch.device("cpu")):
            raise RuntimeError("the step failed")
    assert not _producers()


class _InterruptInEpoch:
    """Loader proxy that raises KeyboardInterrupt before batch `n` of the
    epoch `epoch` (0-based) only."""

    def __init__(self, loader, epoch, n):
        self._loader, self._epoch, self._n = loader, epoch, n

    def __getattr__(self, name):
        return getattr(self._loader, name)

    def __len__(self):
        return len(self._loader)

    def iter_epoch(self, epoch, start_batch=0):
        for i, item in enumerate(self._loader.iter_epoch(epoch, start_batch=start_batch)):
            if epoch == self._epoch and start_batch + i >= self._n:
                raise KeyboardInterrupt
            yield item


def test_two_epochs_resumed_mid_epoch_bitwise(tmp_path):
    cfg = tglow.GlowConfig(in_channels=3, levels=2, steps=1, coupling_width=16)
    tcfg = tnft.NFTrainConfig(epochs=2, lr=1e-3, print_freq=100, save_checkpoint_freq=50)
    data = dict(batch_size=8, img_size=8, synthetic_fallback=True, synthetic_n=48,
                transformations=["RandomHorizontalFlip"])
    logger = logging.getLogger("test_torch_native_batch")

    def train(run_dir, loaders, epochs=2, **kw):
        run_dir.mkdir(exist_ok=True)
        return tnft.train(cfg=cfg, tcfg=tnft.NFTrainConfig(**{**tcfg.__dict__, "epochs": epochs}),
                          loaders=loaders, run_dir=str(run_dir), logger=logger, img_size=8,
                          device="cpu", **kw)

    full = train(tmp_path / "full", tpipe.read_dataset("synthetic", "", **data))
    loaders = tpipe.read_dataset("synthetic", "", **data)
    loaders = type(loaders)(train=_InterruptInEpoch(loaders.train, 1, 2), val=loaders.val,
                            test=loaders.test, eval=loaders.eval)
    run = tmp_path / "interrupted"
    with pytest.raises(KeyboardInterrupt):
        train(run, loaders)
    assert not _producers()
    marker = tckpt.load_mid_epoch_marker(str(run))
    assert marker == {"prefix": "gaussian", "epoch": 2, "batch_in_epoch": 2}
    resumed = train(run, tpipe.read_dataset("synthetic", "", **data), epochs=1,
                    resume_dir=str(run), resume_epoch=2, resume_batch=2)
    a, b = full["state"], resumed["state"]
    assert a["step"] == b["step"] == 12
    for key in ("params", "opt_state"):
        la, lb = dict(convert.named_leaves(a[key])), dict(convert.named_leaves(b[key]))
        assert la.keys() == lb.keys()
        for name in la:
            if isinstance(la[name], torch.Tensor):
                assert torch.equal(la[name].detach(), lb[name].detach()), f"{key}/{name}"
            else:
                assert la[name] == lb[name], f"{key}/{name}"
    assert resumed["results"] == full["results"]
    assert not _producers()
