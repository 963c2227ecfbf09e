#!/usr/bin/env python3
"""Where the time goes inside the whole-step megakernel, on one CUDA card.

    python3 tools/profile_step_megakernel.py

Builds an instrumented copy of nfdpm_tpu_torch/ops/kernels/csrc/
step_megakernel.cu into build/profile/ (the source in the checkout is not
changed): thread 0 of every block reads clock64() at the block's phase
boundaries, which are __syncthreads() barriers, so each count is the time
the whole block spent in that phase; the copy adds one barrier after each
chunk's zeroconv to close that phase. At the three level shapes of the
served Glow (batch 64, width 512, seeded random step weights) it prints one
JSON line each: the kernel's plan, blocks and waves, ms per call (CUDA
events; the instrumented copy, a little slower than the kernel itself), and
SM cycles per block by phase (mean and max over blocks): mix (y_a on the
tile +- 2), conv1 (h1), gemm (the 1x1 conv over all chunks, w2 staging
included), h2_epilogue (actnorm, ReLU, the store of each chunk) and
zeroconv, the rest being the tail. Lines also go to
chiprun_out/profile_step_megakernel.json. Needs CUDA and nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("total", "mix", "conv1", "gemm", "h2_epilogue", "zeroconv")


def instrument(src: str) -> str:
    """The kernel source with clock64() counters written to prof[block][8]."""
    def rep(old, new):
        if src.count(old) != 1:
            raise RuntimeError(f"instrument: the source no longer has {old!r}")
        return src.replace(old, new)

    src = rep("int h, int w, int c, int d, Plan pl) {",
              "int h, int w, int c, int d, Plan pl, long long* prof) {\n"
              "  long long t0 = clock64(), tp = t0, t_mix = 0, t_conv1 = 0, acc_g = 0,\n"
              "            acc_e = 0, acc_z = 0, tg = 0, te = 0, tz = 0;")
    src = rep("h2s[i] = 0.f;\n  __syncthreads();",
              "h2s[i] = 0.f;\n  __syncthreads();\n  t_mix = clock64() - tp; tp = clock64();")
    src = rep("    __syncthreads();  // h1 written; the last chunk's stages consumed",
              "    __syncthreads();  // h1 written; the last chunk's stages consumed\n"
              "    if (n0 == 0) t_conv1 = clock64() - tp;\n    tg = clock64();")
    src = rep("      __syncthreads();  // stage st is refilled two steps on\n    }",
              "      __syncthreads();  // stage st is refilled two steps on\n    }\n"
              "    acc_g += clock64() - tg; te = clock64();")
    src = rep("    __syncthreads();\n    // zeroconv:",
              "    __syncthreads();\n    acc_e += clock64() - te; tz = clock64();\n    // zeroconv:")
    end_of_chunk = re.search(r"zacc\[z\]\[3\]\);\n        \}\n      \}\n    \}\n(?=  \})", src)
    if end_of_chunk is None:
        raise RuntimeError("instrument: the zeroconv loop has changed")
    src = (src[:end_of_chunk.end()] + "    __syncthreads();\n    acc_z += clock64() - tz;\n"
           + src[end_of_chunk.end():])
    src = rep("    rows[pix] = ldj;\n  }\n}",
              "    rows[pix] = ldj;\n  }\n  __syncthreads();\n  if (tid == 0) {\n"
              "    long long* o = prof + (static_cast<long long>(blockIdx.y) * gridDim.x +"
              " blockIdx.x) * 8;\n"
              "    o[0] = clock64() - t0; o[1] = t_mix; o[2] = t_conv1; o[3] = acc_g;\n"
              "    o[4] = acc_e; o[5] = acc_z;\n  }\n}")
    src = rep("int d, int th, int tw, int nc, void* stream) {",
              "int d, int th, int tw, int nc, void* stream, long long* prof) {")
    return src.replace("y, rows, h, w, c, d, pl);", "y, rows, h, w, c, d, pl, prof);")


def build(out_dir: Path) -> ctypes.CDLL:
    from nfdpm_tpu_torch.ops.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    cu, lib = out_dir / "step_megakernel_profile.cu", out_dir / "libstep_megakernel_profile.so"
    cu.write_text(instrument(_build.source("step_megakernel").read_text()))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)], check=True,
                   capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.step_megakernel_f32.argtypes = [p] * 15 + [i] * 8 + [p, p]
    dll.step_megakernel_f32.restype = i
    return dll


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_step_megakernel: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import nfdpm_tpu_torch as port
    from nfdpm_tpu_torch.ops import bijectors as bj
    from nfdpm_tpu_torch.ops.kernels import step_megakernel as sm

    port.disable_tf32()
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    lib = build(ROOT / "build" / "profile")
    clock_khz = torch.cuda.get_device_properties(0).clock_rate
    records = []
    for h, w, c in cs.level_shapes():
        b, d = cs.BATCH, cs.WIDTH
        params = cs.random_step(torch, bj, c, d, seed=b + c)
        wf, bf, _ = bj.fold_actnorm_invconv(params["actnorm"], params["invconv"])
        packed = sm.pack(wf, bf, params["coupling"]["net"], c)
        x = torch.randn((b, h, w, c), generator=torch.Generator(device="cuda").manual_seed(5),
                        device="cuda")
        plan = sm.plan(b, h, w, c, d)
        blocks = -(-h // plan.th) * -(-w // plan.tw) * b
        prof = torch.zeros((blocks, 8), dtype=torch.int64, device="cuda")
        y, rows = torch.empty_like(x), torch.empty((b, h, w), device="cuda")
        ldj = torch.empty((b,), device="cuda")

        def call():
            err = lib.step_megakernel_f32(
                x.data_ptr(), *(t.data_ptr() for t in packed), y.data_ptr(), rows.data_ptr(),
                ldj.data_ptr(), b, h, w, c, d, plan.th, plan.tw, plan.nc,
                torch.cuda.current_stream().cuda_stream, prof.data_ptr())
            if err:
                raise RuntimeError(f"instrumented step_megakernel: CUDA error {err}")

        ms = cs.cuda_ms(call, iters=20, warmup=3)
        y_ref, ldj_ref = sm.step_megakernel_forward_plain(x, wf, bf, params["coupling"]["net"])
        cs.check(torch.allclose(y, y_ref, rtol=cs.MEGA_Y_TOL, atol=cs.MEGA_Y_TOL)
                 and torch.allclose(ldj, ldj_ref, rtol=1e-5, atol=cs.MEGA_LDJ_ATOL),
                 f"the instrumented kernel is wrong at {(b, h, w, c)}")
        cycles = prof[:, :len(PHASES)].double()
        record = {"x": [b, h, w, c], "width": d, "plan": plan._asdict(), "blocks": blocks,
                  "ms": ms, "sm_clock_khz": clock_khz, "nvidia_smi": smi,
                  "cycles_per_block_mean": dict(zip(PHASES, cycles.mean(0).tolist())),
                  "cycles_per_block_max": dict(zip(PHASES, cycles.max(0).values.tolist()))}
        records.append(record)
        print(json.dumps(record), flush=True)
    out = ROOT / "chiprun_out" / "profile_step_megakernel.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
