#!/usr/bin/env python3
"""The rate of mma.sync on this card's tensor cores, for the 3xTF32 kernels.

    python3 tools/probe_mma_rate.py

Builds a small CUDA probe into build/probe/ and times, with CUDA events,
kernels that do nothing but issue mma.sync.m16n8k8 TF32 products (fp32
accumulate, the instruction behind every 3xTF32 product of
csrc/linear_attention.cu and csrc/step_megakernel.cu) on independent
accumulators, one block of 4, 8 or 16 warps on every SM, and the same for
mma.sync.m16n8k16 fp16 and for fp32 FFMA. One JSON line each: TFLOP/s
(2 x 16 x 8 x 8 flops an m16n8k8) beside the card's name and power limit;
also written to chiprun_out/probe_mma_rate.json. The rate bounds what a
3xTF32 kernel on mma.sync can reach: three products a fp32 product. Needs
CUDA and nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SOURCE = r"""
#include <cuda_runtime.h>

// ACC independent accumulators a warp, ITERS rounds of one product each
template <int ACC>
__global__ void mma_tf32_probe(float* out, int iters) {
  float d[ACC][4] = {};
  unsigned a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  unsigned b[2] = {threadIdx.x * 3, threadIdx.x * 5};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < ACC; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
          "{%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < ACC; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int ACC>
__global__ void mma_f16_probe(float* out, int iters) {
  float d[ACC][4] = {};
  unsigned a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  unsigned b[2] = {threadIdx.x * 3, threadIdx.x * 5};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < ACC; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
          "{%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < ACC; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void ffma_probe(float* out, int iters) {
  float v[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) v[j] = threadIdx.x + j;
  const float m = 1.0000001f, c = 1e-7f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = fmaf(v[j], m, c);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) s += v[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int probe(int kind, int blocks, int threads, int iters, float* out) {
  switch (kind) {
    case 0: mma_tf32_probe<8><<<blocks, threads>>>(out, iters); break;
    case 1: mma_f16_probe<8><<<blocks, threads>>>(out, iters); break;
    default: ffma_probe<<<blocks, threads>>>(out, iters); break;
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_mma_rate: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from nfdpm_tpu_torch.ops.kernels import _build

    out_dir = ROOT / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "mma_probe.cu", out_dir / "libmma_probe.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    dll.probe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    dll.probe.restype = ctypes.c_int
    card = cs.nvidia_smi()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty((sms * 512,), device="cuda")
    records = []
    # flops a thread-iteration: 8 products of 2 x 16 x 8 x k a warp / 32 lanes
    kinds = [("mma.sync m16n8k8 tf32", 0, 8 * 2 * 16 * 8 * 8 / 32),
             ("mma.sync m16n8k16 f16", 1, 8 * 2 * 16 * 8 * 16 / 32),
             ("ffma fp32", 2, 16 * 2)]
    iters = 4096
    for name, kind, flops in kinds:
        for warps in (4, 8, 16):
            threads = 32 * warps

            def run():
                err = dll.probe(kind, sms, threads, iters, out.data_ptr())
                if err:
                    raise RuntimeError(f"probe launch failed: {err}")

            ms = cs.cuda_ms(run, iters=10, warmup=2)
            rate = sms * threads * iters * flops / (ms * 1e-3) / 1e12
            record = {"probe": name, "warps_per_sm": warps, "ms": ms, "tflops": rate,
                      "card": card}
            records.append(record)
            print(json.dumps(record), flush=True)
    path = ROOT / "chiprun_out" / "probe_mma_rate.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
