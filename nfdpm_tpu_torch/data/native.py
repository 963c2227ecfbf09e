"""Native host-side batch assembly: the gather of a batch's images, the
uint8 -> fp32 [0, 1] map and the horizontal flip in one multithreaded pass
(csrc/batch_ops.cpp), bound with ctypes.

The port's own copy of what nfdpm_tpu/data/native.py and native/ do. At
first use `g++` compiles the source into
`build/native/libnfdpm_batch_ops.so` at the root of the checkout, under an
`fcntl` lock on `build/native/.build.lock` (ranks that start together run
one compile; the others wait and load it), writing to a temporary name
that `os.replace` renames; a library older than its source is rebuilt.
Where it cannot be built or loaded (no compiler), `batch_gather_normalize`
takes its numpy path, which computes the same bits (x * float32(1/255),
then the flip). Which path a process takes is logged once, with the reason
for the numpy one; `available()` says whether it is the native one, and
`failure()` why not.
Nothing here runs at import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "batch_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
LIBRARY = BUILD_DIR / "libnfdpm_batch_ops.so"
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-shared"]
INV255 = np.float32(1.0 / 255.0)  # the C++ source's 1.0f / 255.0f
# the default thread count: one thread for each THREAD_BYTES of output, at
# most the CPUs this process may run on. Starting a thread costs more than
# copying a small batch: a batch of 64x32x32x3 took 2.35 ms on every
# hardware thread of an H100 host against 0.62 ms on the numpy path
# (chip_smoke.py phase 32, PERF.md §6), 0.20 ms on one thread here.
THREAD_BYTES = 4 << 20

_logger = logging.getLogger(__name__)
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failure: Optional[str] = None  # why the numpy path, once decided


@contextlib.contextmanager
def _build_lock():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build() -> None:
    """Compile the library if it is missing or older than its source;
    raises RuntimeError where there is no compiler or it fails."""
    with _build_lock():
        if LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
            return
        cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++) found")
        tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}): {proc.stderr[-2000:]}")
        os.replace(tmp, LIBRARY)


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and loaded on the first call; None (the numpy
    path) where that failed. Logs the path taken, once."""
    global _lib, _failure
    if _lib is not None or _failure is not None:
        return _lib
    with _lock:
        if _lib is None and _failure is None:
            try:
                build()
                lib = ctypes.CDLL(str(LIBRARY))
                lib.batch_gather_normalize.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_void_p, ctypes.c_int64]
                lib.batch_gather_normalize.restype = None
                _lib = lib
                _logger.info(f"batch assembly: native ({LIBRARY})")
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _failure = str(e) or type(e).__name__
                _logger.warning(f"batch assembly: numpy, the native library is unavailable: "
                                f"{_failure}")
    return _lib


def available() -> bool:
    """True where batch assembly takes the native library."""
    return _load() is not None


def failure() -> Optional[str]:
    """Why batch assembly takes the numpy path (None where it does not)."""
    _load()
    return _failure


def default_threads(out_bytes: int) -> int:
    """One thread for each THREAD_BYTES of output, at most the CPUs this
    process may run on."""
    return max(1, min(len(os.sched_getaffinity(0)), out_bytes // THREAD_BYTES))


def batch_gather_normalize(images: np.ndarray, indices: np.ndarray,
                           flips: Optional[np.ndarray] = None,
                           n_threads: Optional[int] = None,
                           native: Optional[bool] = None) -> np.ndarray:
    """uint8 [N, H, W, C] rows `indices` [B] -> fp32 [B, H, W, C] in [0, 1],
    mirrored along W where `flips` [B] is 1. `native`: None takes the
    library where it is available; False the numpy path; True the library
    or RuntimeError. `n_threads` (the library's): None, default_threads of
    the batch; 0, one a hardware thread."""
    lib = None if native is False else _load()
    if native and lib is None:
        raise RuntimeError(f"the native batch assembly is unavailable: {failure()}")
    indices = np.ascontiguousarray(indices, np.int64)
    if lib is None:
        out = images[indices].astype(np.float32) * INV255
        if flips is not None:
            mask = np.asarray(flips).astype(bool)
            out[mask] = out[mask, :, ::-1, :]
        return out
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w, c = images.shape
    if len(indices) and (indices.min() < 0 or indices.max() >= n):
        raise IndexError(f"batch indices outside the {n} images")
    out = np.empty((len(indices), h, w, c), np.float32)
    if n_threads is None:
        n_threads = default_threads(out.nbytes)
    flips_arr = None if flips is None else np.ascontiguousarray(flips, np.uint8)
    lib.batch_gather_normalize(
        images.ctypes.data, n, h, w, c, indices.ctypes.data,
        None if flips_arr is None else flips_arr.ctypes.data, len(indices),
        out.ctypes.data, n_threads)
    return out
