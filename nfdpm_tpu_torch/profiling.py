"""Where the device time goes in a call: torch.profiler over CUDA kernels.

    rec = profile_call(lambda: sample(params, 64, generator=gen), iters=1)

gives the wall ms per call (host clock around synchronised calls), the
device ms per call (the sum of the CUDA kernels' times in a profiled run of
the same calls, kernels only, so that the host is not slowed by
recording its operators), the device's busy share (device ms / wall ms) and the
device ms by kernel name and by group (GROUPS, first match wins). Needs
CUDA; nothing here runs at import time.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch

# group -> substrings of CUDA kernel names, tried in this order
GROUPS = (
    ("fused_linear_attention", ("fla_fused_kernel", "fla_ctx_pass_kernel",
                                "fla_out_pass_kernel")),
    ("fused_linear_attention backward", ("fla_bwd_",)),
    ("channel_mix + coupling tails", ("channel_mix_", "coupling_tail")),
    ("convolution backward (cuDNN)", ("wgrad", "dgrad", "bwd_data", "bwd_filter",
                                      "backward_data", "backward_filter")),
    ("optimizer and clips (foreach)", ("multi_tensor_apply",)),
    ("convolution (cuDNN)", ("conv", "xmma", "implicit_gemm", "winograd", "fft",
                             "nchwToNhwc", "nhwcToNchw", "cudnn")),
    ("matmul (cuBLAS)", ("gemm", "gemv", "cublas", "trsm", "splitKreduce")),
    ("group norm", ("group_norm", "GroupNorm")),
    ("reduction", ("reduce_kernel", "softmax")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "index_elementwise",
                     "CatArrayBatched", "upsample")),
    ("copy / fill", ("copy", "fill", "Memcpy", "Memset")),
)


def _kernel_times(prof) -> Dict[str, float]:
    """{CUDA kernel name: device µs} over the events that ran on the card
    (the operators that launched them carry the same time and are skipped)."""
    from torch.autograd import DeviceType

    out: Dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.device_time > 0:
            out[e.name] = out.get(e.name, 0.0) + e.device_time
    return out


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def profile_call(fn: Callable[[], object], iters: int = 1, warmup: int = 1,
                 top: int = 15) -> dict:
    """Wall and device time of `fn()`, per call, over `iters` calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / iters * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = {k: us / 1e3 / iters for k, us in _kernel_times(prof).items()}
    if not kernels:
        return {"wall_ms": wall_ms, "device_ms": "not measured",
                "device_busy_share": "not measured"}
    device_ms = sum(kernels.values())
    groups: Dict[str, float] = {}
    for name, ms in kernels.items():
        groups[group_of(name)] = groups.get(group_of(name), 0.0) + ms
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "by_group_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "by_kernel_ms": [[name[:100], ms] for name, ms in ranked]}
