#!/usr/bin/env python3
"""Drive the PyTorch port's Glow serving path once on one CUDA card.

    python3 chip_smoke.py

Runs nfdpm_tpu_torch (never JAX, never nfdpm_tpu) at the width of the
repo's default model: Glow L3/K4, coupling width 512, 32x32x3, batch 64,
5 bits, with seeded random weights. Phases, one JSON line each:

  1. environment: card name and power limit, torch and CUDA versions; both
     TF32 switches must be off;
  2. build: nvcc compiles csrc/flow_kernels.cu for sm_90a;
  3. kernels: each CUDA kernel against its plain PyTorch version at every
     shape the path gives it, plus a ragged case. Times per call: "ms" from
     CUDA events around back-to-back calls as the path makes them (Python
     wrapper included), "device_ms" from replays of a CUDA graph of the
     calls (host taken out); the same for the plain version and, where one
     PyTorch call computes the function, for that call; and the bound;
  4. scoring: bits/dim through inference.make_eval_step, kernel route
     against the plain route (use_kernels=False), within 1e-4;
  5. round trip: inverse(forward(x)) == x within 2e-3;
  6. serving: nfdpm_tpu_torch.serve on 127.0.0.1 answers /health and three
     /generate requests; the launch counters rise by 12 channel_mix and 12
     coupling_tail_inverse launches per 64-image chunk.

The launch counters are zeroed just before phase 4 and read just after
phase 6. Then come the kernel summary line, the nvidia-smi line and, last,
{"ok": true, "device": {...}}. Any failed check raises and exits non-zero
before that line. All records are also written to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import http.client
import io
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LEVELS, STEPS, WIDTH, IMG, BATCH, N_BITS = 3, 4, 512, 32, 64, 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS_PER_S = 67e12   # H100 SXM, fp32 outside the tensor cores
# Operations per element of the two tail kernels, counted from their source:
# forward: add, exp, add, reciprocal, add, mul, add, log, add = 9;
# inverse: add, exp, add, reciprocal, add, div, sub = 7.
TAIL_OPS, TAIL_INV_OPS = 9, 7
RECORDS = []


def emit(record: dict) -> None:
    RECORDS.append(record)
    print(json.dumps(record), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of one call, from CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 50, replays: int = 20) -> float:
    """Mean device time of one call with the host taken out: `calls` calls
    captured in one CUDA graph, replayed `replays` times between events."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def level_shapes():
    """(H, W, C) the Glow steps of each level see: [(16,16,12), (8,8,24), (4,4,48)]."""
    shapes, c, s = [], 3, IMG
    for _ in range(LEVELS):
        c, s = c * 4, s // 2
        shapes.append((s, s, c))
        c //= 2
    return shapes


def phase_environment(torch, port):
    smi = nvidia_smi()
    print(smi, flush=True)
    port.disable_tf32()
    check(torch.backends.cudnn.allow_tf32 is False, "cuDNN TF32 is on")
    check(torch.backends.cuda.matmul.allow_tf32 is False, "cuBLAS TF32 is on")
    emit({"phase": "environment", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "cudnn_allow_tf32": False,
          "matmul_allow_tf32": False})
    return smi


def phase_build(build):
    seconds = build.build()
    log = build.BUILD_LOG.read_text() if build.BUILD_LOG.exists() else ""
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": seconds, "library": str(build.LIBRARY.relative_to(ROOT)),
          "ptxas": ptxas})


def phase_kernels(torch, cm, ct):
    """Each kernel against its plain version; returns per-kernel summaries
    of one pass (4 launches at each of the 3 level shapes)."""
    gen = torch.Generator(device="cuda").manual_seed(1234)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    cases = [(BATCH, h, w, c, STEPS, True) for (h, w, c) in level_shapes()]
    cases.append((37, 3, 5, 14, 0, False))  # ragged: N = 555, D = 105
    timed = ("ms", "plain_ms", "library_ms", "device_ms", "plain_device_ms",
             "library_device_ms")
    totals = {k: dict({t: 0.0 for t in timed}, bytes=0.0, ops=0.0, max_abs_err=0.0)
              for k in ("channel_mix", "coupling_tail", "coupling_tail_inverse")}
    for b, h, w, c, per_pass, on_path in cases:
        o = c if on_path else c + 6  # the ragged case also has O != C
        x, wt, bias = randn(b, h, w, c), randn(o, c, scale=c ** -0.5), randn(o)
        half = (b, h, w, c // 2)
        ls, tb, xb = randn(*half, scale=0.5), randn(*half), randn(*half)
        n, d = b * h * w, h * w * (c // 2)
        x2d = x.view(-1, c)

        # (name, max |kernel - plain|, bytes, ops, kernel, plain, library call)
        rows = []
        y_k, y_p = cm.channel_mix(x, wt, bias), cm.channel_mix_plain(x, wt, bias)
        torch.cuda.synchronize()
        err = float((y_k - y_p).abs().max())
        check(torch.allclose(y_k, y_p, rtol=1e-5, atol=1e-5),
              f"channel_mix differs from its plain version at {tuple(x.shape)}: {err}")
        rows.append(("channel_mix", err, 4 * (n * c + n * o + o * c + o), 2 * n * c * o,
                     lambda: cm.channel_mix(x, wt, bias),
                     lambda: cm.channel_mix_plain(x, wt, bias),
                     lambda: torch.addmm(bias, x2d, wt.T)))

        (yk, lk), (yp, lp) = ct.coupling_tail(ls, tb, xb), ct.coupling_tail_plain(ls, tb, xb)
        torch.cuda.synchronize()
        err = max(float((yk - yp).abs().max()), float((lk - lp).abs().max()))
        check(torch.allclose(yk, yp, rtol=1e-5, atol=1e-5)
              and torch.allclose(lk, lp, rtol=1e-5, atol=1e-4),
              f"coupling_tail differs from its plain version at {half}: {err}")
        rows.append(("coupling_tail", err, 4 * (4 * b * d + b), TAIL_OPS * b * d,
                     lambda: ct.coupling_tail(ls, tb, xb),
                     lambda: ct.coupling_tail_plain(ls, tb, xb), None))

        xk, xp = ct.coupling_tail_inverse(ls, tb, yk), ct.coupling_tail_inverse_plain(ls, tb, yk)
        torch.cuda.synchronize()
        err = float((xk - xp).abs().max())
        check(torch.allclose(xk, xp, rtol=1e-5, atol=1e-5),
              f"coupling_tail_inverse differs from its plain version at {half}: {err}")
        rows.append(("coupling_tail_inverse", err, 4 * 4 * b * d, TAIL_INV_OPS * b * d,
                     lambda: ct.coupling_tail_inverse(ls, tb, yk),
                     lambda: ct.coupling_tail_inverse_plain(ls, tb, yk), None))

        for name, err, nbytes, ops, kernel, plain, library in rows:
            times = {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
                     "library_ms": cuda_ms(library) if library else None,
                     "device_ms": graph_ms(kernel), "plain_device_ms": graph_ms(plain),
                     "library_device_ms": graph_ms(library) if library else None}
            b_ms, b_by = bound_ms(nbytes, ops)
            emit({"phase": "kernel", "name": name, "x": [b, h, w, c],
                  "on_path": on_path, "launches_per_pass": per_pass,
                  "max_abs_err": err, **times, "bound_ms": b_ms, "bound_by": b_by,
                  "bytes": nbytes, "ops": ops})
            tot = totals[name]
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            if on_path:
                tot["bytes"] += per_pass * nbytes
                tot["ops"] += per_pass * ops
                for key in timed:
                    tot[key] += per_pass * (times[key] or 0.0)
    for name, tot in totals.items():
        tot["bound_ms"], tot["bound_by"] = bound_ms(tot["bytes"], tot["ops"])
        if name != "channel_mix":
            tot["library_ms"] = tot["library_device_ms"] = None
    return totals


ZERO_INIT = ("actnorm", "an1", "an2", "zconv", "conv", "prior")
ZERO_INIT_SCALES = {"scale": 0.05, "bias": 0.1, "w": 0.02, "b": 0.05, "logs": 0.05}


def randomize_zero_leaves(torch, params, seed: int):
    """Give the leaves that init leaves at zero (the step and coupling-CNN
    actnorms, zeroconvs, split priors, final prior) small seeded values, so
    no kernel sees a trivial input. The 1x1 convs and the coupling CNN's
    first two convs keep their init."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def walk(node, inside):
        if isinstance(node, list):
            for v in node:
                walk(v, inside)
        elif isinstance(node, dict):
            for k, v in node.items():
                if not isinstance(v, torch.Tensor):
                    walk(v, inside or k in ZERO_INIT)
                elif inside:
                    v.add_(torch.randn(v.shape, generator=gen, device="cuda")
                           * ZERO_INIT_SCALES[k])

    walk(params, False)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs "
              "one CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import nfdpm_tpu_torch as port
    from nfdpm_tpu_torch import convert, inference, serve
    from nfdpm_tpu_torch.models import glow as glow_m
    from nfdpm_tpu_torch.models import prior as prior_m
    from nfdpm_tpu_torch.ops.kernels import _build as build
    from nfdpm_tpu_torch.ops.kernels import channel_mix as cm
    from nfdpm_tpu_torch.ops.kernels import coupling_tail as ct

    import numpy as np

    smi = phase_environment(torch, port)
    phase_build(build)
    totals = phase_kernels(torch, cm, ct)

    device = torch.device("cuda")
    cfg = glow_m.GlowConfig(levels=LEVELS, steps=STEPS, coupling_width=WIDTH)
    plain_cfg = glow_m.GlowConfig(levels=LEVELS, steps=STEPS, coupling_width=WIDTH,
                                  use_kernels=False)
    params = {"flow": glow_m.init_glow(0, cfg, device),
              "prior": prior_m.init_gaussian_prior(glow_m.final_channels(cfg), True, device)}
    randomize_zero_leaves(torch, params, seed=1)
    imgs = np.random.default_rng(2).integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)
    batch = torch.from_numpy(imgs.astype(np.float32) / 255.0).to(device)
    noise = torch.rand(batch.shape, generator=torch.Generator(device="cuda").manual_seed(3),
                       device=device)

    counters = (cm.channel_mix, ct.coupling_tail, ct.coupling_tail_inverse)
    for fn in counters:
        fn.launches = 0

    # 4. scoring
    eval_k = inference.make_eval_step(cfg, N_BITS, device=device)
    eval_p = inference.make_eval_step(plain_cfg, N_BITS, device=device)
    bpd_k, bpd_p = eval_k(params, batch, noise=noise), eval_p(params, batch, noise=noise)
    check(bool(torch.isfinite(bpd_k).all()) and tuple(bpd_k.shape) == (BATCH,),
          "bits/dim not finite or of the wrong shape")
    gap = float((bpd_k - bpd_p).abs().max())
    check(gap <= 1e-4, f"kernel and plain bits/dim differ by {gap}")
    launches_fwd = {fn.__name__: fn.launches for fn in counters}
    check(launches_fwd == {"channel_mix": 3 * STEPS, "coupling_tail": 3 * STEPS,
                           "coupling_tail_inverse": 0},
          f"one forward launched {launches_fwd}")

    def host_ms(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    ms_k = host_ms(lambda: eval_k(params, batch, noise=noise))
    ms_p = host_ms(lambda: eval_p(params, batch, noise=noise))
    emit({"phase": "scoring", "bpd_mean": float(bpd_k.mean()), "max_bpd_gap": gap,
          "tolerance": 1e-4, "ms_per_batch": ms_k, "plain_ms_per_batch": ms_p,
          "batch": BATCH, "launches_one_forward": launches_fwd})

    # 5. round trip
    with torch.inference_mode():
        x = torch.rand((BATCH, IMG, IMG, 3), generator=torch.Generator(device="cuda")
                       .manual_seed(4), device=device) - 0.5
        latents, _, _ = glow_m.forward(params["flow"], cfg, x)
        back = glow_m.inverse(params["flow"], cfg, latents)
        rt = float((back - x).abs().max())
    check(rt <= 2e-3, f"inverse(forward(x)) is off by {rt}")
    emit({"phase": "round_trip", "max_abs_err": rt, "tolerance": 2e-3})

    # 6. serving
    weights = ROOT / "build" / "chip_smoke" / "glow.npz"
    weights.parent.mkdir(parents=True, exist_ok=True)
    convert.save_npz(weights, convert.to_jax_params(params))
    server = serve.make_server(["--weights", str(weights), "--levels", str(LEVELS),
                                "--steps", str(STEPS), "--width", str(WIDTH),
                                "--img-size", str(IMG), "--n-bits", str(N_BITS),
                                "--batch", str(BATCH), "--port", "0"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port_no = server.server_address[1]

        def request(method, path, body=None):
            conn = http.client.HTTPConnection("127.0.0.1", port_no, timeout=300)
            try:
                conn.request(method, path, body=None if body is None else json.dumps(body))
                resp = conn.getresponse()
                return resp.status, dict(resp.getheaders()), resp.read()
            finally:
                conn.close()

        status, _, body = request("GET", "/health")
        check(status == 200 and json.loads(body)["status"] == "ok", "/health failed")
        results = []
        for req in ({"n": 64, "seed": 7}, {"n": 64, "seed": 7}, {"n": 100, "seed": 3}):
            before = {fn.__name__: fn.launches for fn in counters}
            t0 = time.perf_counter()
            status, headers, body = request("POST", "/generate", req)
            wall = time.perf_counter() - t0
            check(status == 200, f"/generate {req} answered {status}")
            with np.load(io.BytesIO(body)) as data:
                samples = data["samples"]
            check(samples.dtype == np.uint8 and samples.shape == (req["n"], IMG, IMG, 3),
                  f"/generate {req} gave {samples.dtype} {samples.shape}")
            chunks = -(-req["n"] // BATCH)
            delta = {k: fn.launches - before[k] for k, fn in
                     zip(before, counters)}
            check(delta == {"channel_mix": 12 * chunks, "coupling_tail": 0,
                            "coupling_tail_inverse": 12 * chunks},
                  f"/generate {req}: launch counts {delta} for {chunks} chunk(s)")
            results.append({"request": req, "wall_s": wall,
                            "generation_s": float(headers["X-Generation-Seconds"]),
                            "samples_per_s": req["n"] / float(headers["X-Generation-Seconds"]),
                            "launches": delta, "samples": samples})
        check(np.array_equal(results[0]["samples"], results[1]["samples"]),
              "the same seed gave different samples")
        check(not np.array_equal(results[0]["samples"][:64], results[2]["samples"][:64]),
              "different seeds gave the same samples")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    launches = {fn.__name__: fn.launches for fn in counters}
    for r in results:
        r.pop("samples")
    emit({"phase": "serving", "warmup_s": server.info["warmup_seconds"],
          "requests": results, "main_path_launches": launches})
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on the main path")

    sources = {"channel_mix": "nfdpm_tpu/ops/pallas/channel_mix.py:70",
               "coupling_tail": "nfdpm_tpu/ops/pallas/coupling_tail.py:75",
               "coupling_tail_inverse": "nfdpm_tpu/ops/pallas/coupling_tail.py:127"}
    kernels = [{"name": name, "route": "cuda",
                "source": "nfdpm_tpu_torch/ops/kernels/csrc/flow_kernels.cu",
                "replaces": sources[name], "launches": launches[name],
                "max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
                "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                "bound_by": tot["bound_by"], "library_ms": tot["library_ms"],
                "device_ms": tot["device_ms"], "plain_device_ms": tot["plain_device_ms"],
                "library_device_ms": tot["library_device_ms"],
                "per": "one pass: 4 launches at each of the 3 level shapes"}
               for name, tot in totals.items()]
    summary = {"kernels": kernels}
    RECORDS.append(summary)
    out = ROOT / "chiprun_out" / "chip_smoke.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(RECORDS, indent=1))
    print(json.dumps(summary), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
