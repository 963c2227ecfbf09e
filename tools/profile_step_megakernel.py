#!/usr/bin/env python3
"""Where the time goes inside the whole-step megakernel, on one CUDA card.

    python3 tools/profile_step_megakernel.py

Builds nfdpm_tpu_torch/ops/kernels/csrc/step_megakernel.cu a second time,
with STEP_MEGAKERNEL_PROFILE defined, into build/profile/ (the source is
not changed): that turns on its MK_MARK stamps, where thread 0 of every
block adds the SM cycles since its previous stamp to the phase's slot. Most
stamps follow a product, which ends with a barrier, so a slot is about the
time the whole block spent in that phase. At the three level shapes of the
served Glow (batch 64, width 512, seeded random step weights) it prints one
JSON line each: the kernel's plan, blocks and waves, ms per call (CUDA
events; both kernels), the device us of the main kernel and of the
gather-and-tail kernel (torch.profiler), and SM cycles per block by phase
(mean and max over blocks):
  mix          y_a on the block's pixels +- (W + 1) and conv1's im2col tile
  conv1        conv1's products and their actnorm and ReLU into h1
  gemm         the 1x1 conv's products, all chunks
  h2_epilogue  each chunk's actnorm and ReLU into shared memory
  zeroconv     the scatter zeroconv's products, all chunks
  store        Z's rows to device memory
Lines also go to chiprun_out/profile_step_megakernel.json. Needs CUDA and
nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("mix", "conv1", "gemm", "h2_epilogue", "zeroconv", "store")
SLOTS = 8  # csrc/step_megakernel.cu: PROF_SLOTS


def build(out_dir: Path) -> ctypes.CDLL:
    from nfdpm_tpu_torch.ops.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libstep_megakernel_profile.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DSTEP_MEGAKERNEL_PROFILE", "-o",
                    str(lib), str(_build.source("step_megakernel"))],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    argtypes, restype = _build._SIGNATURES["step_megakernel"]["step_megakernel_f32"]
    dll.step_megakernel_f32.argtypes, dll.step_megakernel_f32.restype = argtypes, restype
    dll.step_megakernel_profile_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dll.step_megakernel_profile_read.restype = ctypes.c_int
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
        y = torch.empty_like(x)
        z = torch.empty((b * h * w, sm.z_cols(c)), device="cuda")
        ldj = torch.empty((b,), device="cuda")

        def call():
            err = lib.step_megakernel_f32(
                x.data_ptr(), *(t.data_ptr() for t in packed), y.data_ptr(), z.data_ptr(),
                ldj.data_ptr(), b, h, w, c, d, plan.mt, plan.stages,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"instrumented step_megakernel: CUDA error {err}")

        ms = cs.cuda_ms(call, iters=20, warmup=3)
        kernels = cs.kernel_events(torch, call)
        y_ref, ldj_ref = sm.step_megakernel_forward_plain(x, wf, bf, params["coupling"]["net"])
        cs.check(torch.allclose(y, y_ref, rtol=cs.MEGA_Y_TOL, atol=cs.MEGA_Y_TOL)
                 and torch.allclose(ldj, ldj_ref, rtol=1e-5, atol=cs.MEGA_LDJ_ATOL),
                 f"the instrumented kernel is wrong at {(b, h, w, c)}")
        prof = torch.zeros((plan.blocks, SLOTS), dtype=torch.int64)
        err = lib.step_megakernel_profile_read(prof.data_ptr(), plan.blocks)
        if err:
            raise RuntimeError(f"step_megakernel_profile_read: CUDA error {err}")
        cycles = prof[:, :len(PHASES)].double()
        mean, peak = cycles.mean(0).tolist(), cycles.max(0).values.tolist()
        record = {"x": [b, h, w, c], "width": d, "plan": plan._asdict(),
                  "waves": -(-plan.blocks // 132), "ms": ms,
                  "device_us": {name[:60]: us for name, us in kernels},
                  "sm_clock_khz": clock_khz, "nvidia_smi": smi,
                  "cycles_per_block_mean": dict(zip(PHASES, mean), total=sum(mean)),
                  "cycles_per_block_max": dict(zip(PHASES, peak))}
        records.append(record)
        print(json.dumps(record), flush=True)
    out = ROOT / "chiprun_out" / "profile_step_megakernel.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
