"""Run one cell of the benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's chips. Set-up
builds the program's kernels that the cell runs (into build/ of the
checkout, once; `about.setup_parts_s.build` gives the seconds apart), makes
the inputs from the seed on the device and warms every shape the cell uses;
then the window: calls of the cell's entry, one after another (a closed
loop of one caller), until `--seconds` have passed; the call running then
finishes inside the window. Each call is timed by CUDA events on the
stream, read after the window. After the window the peak memory is read,
the program's state freed, and the reference checks what the window
produced (the cell's entry says how); the numbers compared stand, with
their limits, last on standard error and last in the result line.

With --trace 1 the window runs under torch.profiler, recording the
device's activity alone, ends after the cell's `trace_calls` calls at
most, and the line holds the per-layer metrics;
with --trace 0 the end-to-end ones. The last line of standard output is
one JSON object: correct, attempted, failed, metrics, device (and, traced,
breakdown), then checks.
"""

from __future__ import annotations

import time

START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the program's and the libraries' caches, at fixed paths inside the checkout,
# whatever the environment names
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "perfbench_cache" / sub)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench.bench import manifest, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "nfdpm_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (nfdpm_tpu_torch is not nfdpm_tpu)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _window(cell, seconds: float, cap, device):
    """Run calls until `seconds` have passed (or `cap` calls); returns
    (calls, window seconds, per-call ms)."""
    cuda = device.type == "cuda"
    marks = []
    t0 = time.perf_counter()
    i = 0
    while (i == 0 or time.perf_counter() - t0 < seconds) and (cap is None or i < cap):
        if cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        else:
            h0 = time.perf_counter()
        cell.call(i)
        if cuda:
            e1.record()
            marks.append((e0, e1))
        else:
            marks.append((time.perf_counter() - h0) * 1e3)
        i += 1
    if cuda:
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    call_ms = [e0.elapsed_time(e1) for e0, e1 in marks] if cuda else marks
    return i, window_s, call_ms


def build(entry) -> float:
    """Build the program's kernel libraries that `entry` runs (nvcc, and
    g++ for the native batch assembly where it declares NATIVE), or find
    them current; returns the seconds. A checkout's first run compiles
    them into build/ of the checkout; later runs load them from there."""
    from nfdpm_tpu_torch.data import native
    from nfdpm_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.build(entry.LIBRARIES)
    if getattr(entry, "NATIVE", False):
        native.build()
    return time.perf_counter() - t0


def run(spec: manifest.Cell, seed: int, seconds: float, traced: bool, device,
        start: float = START) -> dict:
    """One run of the cell `spec`; returns the result line's object (the
    caller has checked the device)."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    entry = manifest.entry_module(spec.entry)
    parts = {"imports": time.time() - start}
    if cuda:
        parts["build"] = build(entry)
    t0 = time.time()
    cell = entry.Cell(spec, seed, device)
    if cuda:
        torch.cuda.synchronize(device)
    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's later passes
    parts["cell"] = time.time() - t0
    setup_s = time.time() - start
    summary, cap = None, (spec.cell["trace_calls"] if traced else None)
    if traced and cuda:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CUDA]  # the device alone: see perfbench/bench/trace.py
        with profile(activities=activities):  # the profiler's own start-up, outside the window
            torch.ones(1, device=device).add_(1)
        for _ in range(3):  # a trace now and then comes back with no device activity
            with profile(activities=activities) as prof:
                calls, window_s, call_ms = _window(cell, seconds, cap, device)
            summary = trace.summarize(prof, window_s)
            del prof
            if summary is not None:
                break
    else:
        calls, window_s, call_ms = _window(cell, seconds, cap, device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    work = cell.work()
    cell.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = cell.check()
    limits = spec.cell["check"]["limits"]
    correct = all(math.isfinite(v) and v <= limits[k] for k, v in checks.items())

    ctx = types.SimpleNamespace(spec=spec, trace=summary, calls=calls,
                                images=calls * cell.images_per_call, window_s=window_s,
                                call_ms=call_ms, setup_s=setup_s, peak_bytes=peak, work=work)
    metrics = {}
    for m in (spec.per_layer if traced else spec.end_to_end):
        value = manifest.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": calls, "failed": 0, "metrics": metrics,
           "device": dev}
    if traced and summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
        out["breakdown"] = {"device_ops": summary.device_ops(10),
                            "idle_gaps": [[n, s] for n, s in summary.gaps[:10]]}
    if traced and cuda:
        dev["power_limit"] = power_limit()
    out["about"] = {"setup_s": setup_s,
                    "setup_parts_s": {**parts, **getattr(cell, "setup_parts", {})},
                    "window_s": window_s,
                    "call_ms_quartiles": [float(q) for q in np.percentile(call_ms, [0, 25, 50, 75, 100])],
                    **work.get("about", {})}
    out["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = manifest.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"perfbench: {args.workload} needs {spec.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    out = run(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 4
    if out["device"].get("power_limit"):
        print(f"card: {out['device']['power_limit']}", file=sys.stderr)
    setup_parts = ", ".join(f"{k} {v:.1f}" for k, v in out["about"]["setup_parts_s"].items())
    print(f"seconds: setup {out['about']['setup_s']:.1f} ({setup_parts}), "
          f"whole run {time.time() - START:.1f}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
