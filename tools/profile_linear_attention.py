#!/usr/bin/env python3
"""Where the time goes inside the fused_linear_attention kernels, on one CUDA card.

    python3 tools/profile_linear_attention.py

Builds an instrumented copy of nfdpm_tpu_torch/ops/kernels/csrc/
linear_attention.cu into build/profile/ (the source in the checkout is not
changed): thread 0 of every block reads clock64() at the forward kernels'
phase boundaries, most of which follow a __syncthreads() barrier, so each
count is about the time the whole block spent in that phase. The port's
wrapper then runs on that copy at each distinct linear-attention call of the
served UNet (configs/nf_diffusion.yaml, batch 64, seeded random weights),
and one JSON line per call gives the plan and SM cycles per block by phase
(mean and max over blocks):
  fused:  proj (x tile, x W_qkv), softmax (q, k, v / N), ctx (k_s^T v),
          o (q ctx), out_gemm (o W_out), layernorm;
  split:  ctx pass: kv_gemm, softmax, partial_ctx;
          output pass: combine, q_gemm, q_softmax, o, out_gemm, layernorm.
Then the backward at the same calls (the shapes of a stage-2 train step):
the copy is built with FLA_BWD_PROFILE, which turns on the BWD_STAMP
marks of the backward kernels, and `_backward_kernel` runs on it:
  fused:     proj (x W_qkv), softmax (q; k_s, v_s), o (q ctx), out_gemm
             (o W_out), layernorm_bwd, do (dy W_out^T), dq, dctx, dk_dv;
  split:     row pass: q_proj, q_softmax, o, out_gemm, layernorm_bwd, do,
             dq, dctx_partial;
             k/v pass: combine (the dctx partials), kv_gemm (and S),
             softmax (k_s, v_s), dk_dv.
Lines also go to chiprun_out/profile_linear_attention.json. Needs CUDA and
nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SLOTS = 16
FUSED = ("proj", "softmax", "ctx", "o", "out_gemm", "layernorm")
CTX_PASS = ("kv_gemm", "softmax", "partial_ctx")
OUT_PASS = ("combine", "q_gemm", "q_softmax", "o", "out_gemm", "layernorm")
BWD_FUSED = ("proj", "softmax", "o", "out_gemm", "layernorm_bwd", "do", "dq", "dctx",
             "dk_dv")
BWD_ROWS = ("q_proj", "q_softmax", "o", "out_gemm", "layernorm_bwd", "do", "dq",
            "dctx_partial")
BWD_KV = ("combine", "kv_gemm", "softmax", "dk_dv")
UNET_CALLS = [(16, 64), (8, 64), (8, 128), (4, 64), (4, 128), (2, 64), (2, 128)]


def instrument(src: str) -> str:
    """The source with clock64() stamps written to fla_prof[block][16]."""
    def rep(old, new):
        if src.count(old) != 1:
            raise RuntimeError(f"instrument: the source no longer has {old!r}")
        return src.replace(old, new)

    stamp = ("if (threadIdx.x == 0) fla_prof[(blockIdx.y * gridDim.x + blockIdx.x) * 16 + {}]"
             " = clock64();\n")
    src = rep("#include <math.h>\n", "#include <math.h>\n\n__device__ long long fla_prof[1 << 16];\n")
    src = "#define FLA_BWD_PROFILE\n" + src
    # fused kernel
    for i, anchor in enumerate(("  // 1. qkv = x W_qkv", "  // 2. q's per-head softmax",
                                "  // 3. contexts ctx[h]", "  // 4. o = q ctx",
                                "  // 5. y = LayerNorm")):
        src = rep(anchor, "  " + stamp.format(i) + anchor)
    ln = "  layer_norm_store(acc, bout, g, y + static_cast<long long>(b) * n * c, n, c, red);\n"
    src = rep(ln, "  " + stamp.format(5) + ln + "  " + stamp.format(6))
    # split: context pass
    start = ("const int tile = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;\n"
             "  const int n0 = tile * SPLIT_TOK, rows = min(SPLIT_TOK, n - n0);\n")
    src = rep(start, start + "  " + stamp.format(0))
    anchor = "  float* pt = part + (static_cast<long long>(b) * gridDim.x + tile) * PART_FLOATS;\n"
    src = rep(anchor, "  " + stamp.format(1) + anchor)
    anchor = ("    pt[HEADS * DH * DH + HIDDEN + tid] = ms.y;\n  }\n  __syncthreads();\n")
    src = rep(anchor, anchor + "  " + stamp.format(2))
    anchor = ("            *reinterpret_cast<float2*>(pt + (h * DH + d) * DH + e) = "
              "make_float2(c0, c1);\n          });\n}")
    src = rep(anchor, anchor[:-1] + "  " + stamp.format(3) + "}")
    # split: output pass
    start = ("const int b = blockIdx.y, tid = threadIdx.x;\n"
             "  const int n0 = blockIdx.x * SPLIT_TOK, rows = min(SPLIT_TOK, n - n0);\n")
    src = rep(start, start + "  " + stamp.format(8))
    for i, anchor in ((9, "  // q = x W_q\n"), (10, "  q_softmax(qs, Q_LD, SPLIT_TOK);\n"),
                      (11, "  q_ctx_mma<4>(qs, Q_LD, cs, os, Q_LD);"),
                      (12, "  float acc[4][NTO][4];\n")):
        src = rep(anchor, "  " + stamp.format(i) + anchor)
    ln = ("  layer_norm_store(acc, bout, g, y + (static_cast<long long>(b) * n + n0) * c, rows, "
          "c, red);\n")
    src = rep(ln, "  " + stamp.format(13) + ln + "  " + stamp.format(14))
    src = rep('}  // extern "C"',
              "int fla_prof_read(long long* out, int count) {\n"
              "  return static_cast<int>(cudaMemcpyFromSymbol(out, fla_prof,\n"
              "                                               count * sizeof(long long)));\n"
              "}\n\n"
              "int fla_bwd_prof_read(long long* out, int count) {\n"
              "  return static_cast<int>(cudaMemcpyFromSymbol(out, fla_bwd_prof,\n"
              "                                               count * sizeof(long long)));\n"
              "}\n\n}  // extern \"C\"")
    return src


def load_instrumented(build):
    out_dir = ROOT / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "linear_attention_prof.cu"
    src.write_text(instrument(build.source("attention_kernels").read_text()))
    lib_path = out_dir / "libattention_prof.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in build._SIGNATURES["attention_kernels"].items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    for reader in (lib.fla_prof_read, lib.fla_bwd_prof_read):
        reader.argtypes, reader.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    # the wrappers launch through _build.function: point it at the copy
    build._libraries["attention_kernels"] = lib
    for key in [k for k in build._functions if k[0] == "attention_kernels"]:
        del build._functions[key]
    return lib


def phases(stamps, names, first):
    """{name: (mean, max)} of the cycles between consecutive stamps."""
    out = {}
    for i, name in enumerate(names):
        d = [row[first + i + 1] - row[first + i] for row in stamps]
        out[name] = (sum(d) / len(d), max(d))
    total = [row[first + len(names)] - row[first] for row in stamps]
    out["total"] = (sum(total) / len(total), max(total))
    return out


def read_stamps(reader, blocks):
    buf = (ctypes.c_longlong * (blocks * SLOTS))()
    if reader(ctypes.addressof(buf), blocks * SLOTS) != 0:
        raise RuntimeError("reading the stamps failed")
    return [buf[i * SLOTS:(i + 1) * SLOTS] for i in range(blocks)]


def cycles_record(cycles):
    return {k: {ph: [round(v[0]), v[1]] for ph, v in d.items()} for k, d in cycles.items()}


def profile_backward(torch, fla, lib, gen, side, c):
    """SM cycles by phase of the backward kernels at one call (batch 64)."""
    b, n = 64, side * side
    args = (torch.randn((b, side, side, c), generator=gen, device="cuda"),
            torch.randn((c, 384), generator=gen, device="cuda") * c ** -0.5,
            torch.randn((128, c), generator=gen, device="cuda") * 128 ** -0.5,
            torch.randn((c,), generator=gen, device="cuda") * 0.1,
            1.0 + torch.randn((c,), generator=gen, device="cuda") * 0.1)
    dout = torch.randn((b, side, side, c), generator=gen, device="cuda")
    _, ctx, stats = fla._forward_kernel(*args)
    p = fla.bwd_plan(n, c)
    for _ in range(3):
        grads = fla.fused_linear_attention_bwd(*args, ctx, stats, dout)
    torch.cuda.synchronize()
    want = fla.fused_linear_attention_bwd_plain(*args, dout)
    err = max(float((a - e).abs().max()) for a, e in zip(grads, want))
    blocks = b if p.fused else b * -(-n // (16 * p.m_tiles))
    stamps = read_stamps(lib.fla_bwd_prof_read, blocks)
    if p.fused:
        cycles = {"fused": phases(stamps, BWD_FUSED, 0)}
    else:
        cycles = {"row_pass": phases(stamps, BWD_ROWS, 0), "kv_pass": phases(stamps, BWD_KV, 10)}
    return {"direction": "backward", "x": [b, side, side, c], "plan": p._asdict(),
            "blocks": blocks, "max_abs_err": err, "cycles_mean_max": cycles_record(cycles)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_linear_attention: no CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import nvidia_smi
    from nfdpm_tpu_torch import disable_tf32
    from nfdpm_tpu_torch.ops.kernels import _build
    from nfdpm_tpu_torch.ops.kernels import fused_linear_attention as fla

    disable_tf32()
    lib = load_instrumented(_build)
    records = [{"card": nvidia_smi(), "torch": torch.__version__}]
    print(json.dumps(records[0]), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    for side, c in UNET_CALLS:
        b, n = 64, side * side
        args = (torch.randn((b, side, side, c), generator=gen, device="cuda"),
                torch.randn((c, 384), generator=gen, device="cuda") * c ** -0.5,
                torch.randn((128, c), generator=gen, device="cuda") * 128 ** -0.5,
                torch.randn((c,), generator=gen, device="cuda") * 0.1,
                1.0 + torch.randn((c,), generator=gen, device="cuda") * 0.1)
        p = fla.plan(n, c)
        for _ in range(3):
            y = fla.fused_linear_attention(*args)
        torch.cuda.synchronize()
        err = float((y - fla.fused_linear_attention_plain(*args)).abs().max())
        # the grid: a block a batch row (fused), or a block a row's token tile
        blocks = b if p.fused else b * -(-n // fla.SPLIT_TOK)
        stamps = read_stamps(lib.fla_prof_read, blocks)
        if p.fused:
            cycles = {"fused": phases(stamps, FUSED, 0)}
        else:
            cycles = {"ctx_pass": phases(stamps, CTX_PASS, 0),
                      "out_pass": phases(stamps, OUT_PASS, 8)}
        rec = {"direction": "forward", "x": [b, side, side, c], "plan": p._asdict(),
               "blocks": blocks, "max_abs_err": err, "cycles_mean_max": cycles_record(cycles)}
        records.append(rec)
        print(json.dumps(rec), flush=True)
    for side, c in UNET_CALLS:
        rec = profile_backward(torch, fla, lib, gen, side, c)
        records.append(rec)
        print(json.dumps(rec), flush=True)
    out = ROOT / "chiprun_out" / "profile_linear_attention.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
