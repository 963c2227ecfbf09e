"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source has a plain C interface and becomes one shared library: at
first use, `nvcc` compiles it for Hopper (`sm_90a`) into
`build/kernels/lib<name>.so` at the root of the checkout, and `ctypes`
loads it. A library is rebuilt when it is missing or older than its source
or than a header the sources share (csrc/*.cuh).
`build()` starts one `nvcc` per stale source, all at once, and waits for
them together. It holds an `fcntl` lock on `build/kernels/.build.lock`
around the staleness check, the build and the rename, so that processes
that start together (the ranks of a data-parallel launch) run one compile:
the others wait, find the library current and load it; nvcc writes to a
temporary name that `os.replace` renames, so no process loads a
half-written file. Nothing here runs at import time: the CPU tests import
every module, and the CPU has no `nvcc`. A recording (utils/profiling.py)
counts the libraries built (`kernels.built`) and loaded (`kernels.loaded`)
while it is on, so a build inside a timed window shows.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from ...utils.profiling import count

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# library name -> its source under csrc/
SOURCES = {"flow_kernels": "flow_kernels.cu",
           "attention_kernels": "linear_attention.cu",
           "step_megakernel": "step_megakernel.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "flow_kernels": {
        "channel_mix_f32": ([_P, _P, _P, _P, ctypes.c_longlong] + [_I] * 5 + [_P], _I),
        "coupling_tail_f32": ([_P] * 5 + [_I, _L] + [_I] * 3 + [_P], _I),
        "coupling_tail_step_f32": ([_P] * 7 + [_I, _L] + [_I] * 4 + [_P], _I),
        "coupling_tail_inverse_f32": ([_P] * 4 + [_L] + [_I] * 3 + [_P], _I),
        "coupling_tail_inverse_step_f32": ([_P] * 5 + [_I, _L] + [_I] * 4 + [_P], _I),
        "coupling_tail_bwd_f32": ([_P] * 5 + [_L] + [_P] * 2 + [_I, _L] + [_I] * 4 + [_P], _I),
        "coupling_tail_step_bwd_f32": ([_P] * 6 + [_L] + [_P] * 6 + [_I, _L] + [_I] * 5
                                       + [_P], _I),
    },
    "attention_kernels": {
        "fused_linear_attention_plan_smem": ([_I] * 3, ctypes.c_longlong),
        "fused_linear_attention_f32": ([_P] * 9 + [_I] * 6 + [_P], _I),
        "fused_linear_attention_bwd_smem_bytes": ([_I] * 3, ctypes.c_longlong),
        "fused_linear_attention_bwd_f32": ([_P] * 13 + [_I] * 6 + [_P], _I),
    },
    "step_megakernel": {
        "step_megakernel_smem_bytes": ([_I] * 6, ctypes.c_longlong),
        "step_megakernel_f32": ([_P] * 15 + [_I] * 7 + [_P], _I),
    },
}

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}
# (library, entry point) -> its ctypes function, filled on first use
_functions: Dict[Tuple[str, str], Any] = {}


def source(name: str) -> Path:
    return CSRC / SOURCES[name]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build_log(name: str) -> Path:
    return BUILD_DIR / f"{name}.build.log"


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _stale(name: str) -> bool:
    """True where the library is missing or older than its source or a
    header beside it (csrc/*.cuh, which the sources include)."""
    lib = library_path(name)
    newest = max(p.stat().st_mtime for p in [source(name), *CSRC.glob("*.cuh")])
    return not lib.exists() or lib.stat().st_mtime < newest


@contextlib.contextmanager
def _build_lock():
    """An exclusive lock on BUILD_DIR/.build.lock, across processes; held
    until the block ends (released by the kernel if the process dies)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile the named libraries (default: all) that are missing or stale,
    one nvcc process per source, started together; returns the seconds
    spent compiling (0.0 when every library was current). Under the build
    lock: a process that waited for another's build finds it current."""
    with _build_lock():
        return _build_stale(names)


def _build_stale(names: Optional[Iterable[str]]) -> float:
    stale = [n for n in (SOURCES if names is None else names) if _stale(n)]
    if not stale:
        return 0.0
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in stale:
        lib = library_path(name)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source(name))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        build_log(name).write_text(out + err)
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]} ({proc.returncode}):\n{err}")
        else:
            os.replace(tmp, library_path(name))
            count("kernels.built")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed (the lock is
    taken only until it is loaded)."""
    lib = _libraries.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libraries:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn_name, (argtypes, restype) in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes, fn.restype = argtypes, restype
            _libraries[name] = lib
            count("kernels.loaded")
    return _libraries[name]


def check_cuda_f32(name: str, *tensors: torch.Tensor) -> torch.device:
    """Raise unless every tensor is contiguous fp32 on one CUDA device."""
    index = tensors[0].get_device()  # -1 off CUDA
    for t in tensors:
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"{name}: all inputs must lie on one CUDA device, "
                             f"got {[str(u.device) for u in tensors]}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expects float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous inputs")
    return tensors[0].device


def refuse_gradient(name: str, reason: str, *tensors: torch.Tensor) -> None:
    """Raise when a gradient would be wanted through a wrapper that has none:
    its output would come back detached and the gradient silently missing."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no gradient ({reason}): call it under "
            "torch.no_grad() or torch.inference_mode(), or on tensors that do "
            "not require grad")


def function(lib_name: str, fn_name: str):
    """The ctypes function `fn_name` of library `lib_name`, built, loaded and
    typed on first use; after that a dictionary lookup, with no lock."""
    fn = _functions.get((lib_name, fn_name))
    if fn is None:
        fn = getattr(library(lib_name), fn_name)
        _functions[(lib_name, fn_name)] = fn
    return fn


def launch(name: str, fn, device: torch.device, *args) -> None:
    """Call the entry point `fn` with `args` and PyTorch's current stream of
    `device` (so that CUDA-graph capture records the launch), entering a
    `torch.cuda.device` context only when `device` is not the current one;
    raise if the launch was refused. The stream handle comes from
    `torch._C._cuda_getCurrentRawStream`, the call PyTorch's own generated
    kernels launch with: the same handle as
    `torch.cuda.current_stream(device).cuda_stream` without building a
    Stream object (0.2 against 3 us a call on the H100's host)."""
    index = device.index
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
