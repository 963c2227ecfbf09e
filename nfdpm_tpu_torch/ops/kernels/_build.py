"""Build and load the hand-written CUDA kernels (csrc/flow_kernels.cu).

The source has a plain C interface. At first use, `nvcc` compiles it for
Hopper (`sm_90a`) into `build/kernels/libflow_kernels.so` at the root of
the checkout, and `ctypes` loads it. The library is rebuilt when it is
missing or older than its source. Nothing here runs at import time: the
CPU tests import every module, and the CPU has no `nvcc`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "flow_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIBRARY = BUILD_DIR / "libflow_kernels.so"
BUILD_LOG = BUILD_DIR / "build.log"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_SIGNATURES = {
    "channel_mix_smem_bytes": ([ctypes.c_int, ctypes.c_int], ctypes.c_longlong),
    "channel_mix_f32": ([_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_int, _P], ctypes.c_int),
    "coupling_tail_f32": ([_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong,
                           _P], ctypes.c_int),
    "coupling_tail_inverse_f32": ([_P, _P, _P, _P, ctypes.c_longlong, _P],
                                  ctypes.c_int),
}

_lock = threading.Lock()
_library: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build() -> float:
    """Compile the library if it is missing or stale; returns the seconds
    spent compiling (0.0 when the built library was current)."""
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    BUILD_LOG.write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _library
    with _lock:
        if _library is None:
            build()
            lib = ctypes.CDLL(str(LIBRARY))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _library = lib
    return _library


def check_cuda_f32(name: str, *tensors: torch.Tensor) -> torch.device:
    """Raise unless every tensor is contiguous fp32 on one CUDA device."""
    device = tensors[0].device
    for t in tensors:
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must lie on one CUDA device, "
                             f"got {[str(u.device) for u in tensors]}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expects float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous inputs")
    return device


def raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
