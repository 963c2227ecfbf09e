"""Run one cell's traced window with the port's spans recorded, and print
its per-layer metrics with each device second and each idle gap put down to
the span that launched the work (perfbench/bench/spans.py).

    python3 perfbench/tools/attribute.py --workload glow-cifar10.train \
        --seed 3000000017 --seconds 51 [--out spans.jsonl]

Set-up and the window are perfbench/run.py's with --trace 1 (the same
build, cell, profiler recording the device alone, `trace_calls` cap and
three tries), with utils.profiling.recording() on around each try's window;
no check against the reference is made. The last line of standard output is
one JSON object: metrics (the cell's per-layer metrics and those of
SPAN_METRICS that name it), device, breakdown (device_ops, idle_gaps,
device_by_span, idle_by_span: the ten largest), about (window_s, calls,
shares: what of the device time and of the idle time went to named spans,
to the harness and to no launch, spans: count, host_ms, self_ms, device_ms
and idle_ms by span name, counters). `--out` appends the line to a file.

SPAN_METRICS lists the readers under perfbench/metrics/ that read spans,
with the cells each applies to; BENCHMARK.json does not list them, as
perfbench/run.py records no spans.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import run  # noqa: E402  (also fixes the caches' paths)

import torch  # noqa: E402

from perfbench.bench import manifest, spans, trace  # noqa: E402

GLOW = ("glow-cifar10.train", "glow-cifar10.sample")
# name -> (unit, the cells it applies to)
SPAN_METRICS = {
    "host_ms_per_call": ("ms", GLOW + ("nfdp-cifar10.sample",)),
    "flow_span_roofline": ("%", GLOW),
    "attention_span_roofline": ("%", ("nfdp-cifar10.sample",)),
    "optimizer_span_device_ms_per_step": ("ms", ("glow-cifar10.train",)),
    "loader_producer_ms_per_batch": ("ms", ("glow-cifar10.train",)),
}


def _shares(attr: spans.Attribution) -> dict:
    out = {}
    for kind, table in (("device", attr.device_s), ("idle", attr.idle_s)):
        total = sum(table.values())
        if total > 0:
            named = total - table.get(spans.HARNESS, 0.0) - table.get(spans.UNATTRIBUTED, 0.0)
            out[kind] = {"spans": named / total,
                         spans.HARNESS: table.get(spans.HARNESS, 0.0) / total,
                         spans.UNATTRIBUTED: table.get(spans.UNATTRIBUTED, 0.0) / total}
    return out


def traced(spec: manifest.Cell, seed: int, seconds: float, device) -> dict:
    """One traced window of `spec` with spans recorded; the result line's
    object. On the CPU the window is recorded without the profiler and
    only the spans' host times are read."""
    from nfdpm_tpu_torch.utils import profiling

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    entry = manifest.entry_module(spec.entry)
    if cuda:
        run.build(entry)
    cell = entry.Cell(spec, seed, device)
    if cuda:
        torch.cuda.synchronize(device)
    gc.collect()
    gc.freeze()
    cap = spec.cell["trace_calls"]
    summary = attr = None
    if cuda:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CUDA]
        with profile(activities=activities):
            torch.ones(1, device=device).add_(1)
        for _ in range(3):  # as perfbench/run.py: a trace now and then has no device activity
            with profiling.recording() as rec, profile(activities=activities) as prof:
                t0 = time.time_ns()
                calls, window_s, call_ms = run._window(cell, seconds, cap, device)
                t1 = time.time_ns()
            summary = trace.summarize(prof, window_s)
            if summary is not None:
                attr = spans.of_trace(prof, rec, (t0, t1))
                break
            del prof
    else:
        with profiling.recording() as rec:
            calls, window_s, call_ms = run._window(cell, seconds, cap, device)
        attr = spans.attribute([], {}, rec.spans, counters=rec.counters)
    work = cell.work()
    cell.close()
    ctx = types.SimpleNamespace(spec=spec, trace=summary, spans=attr, calls=calls,
                                images=calls * cell.images_per_call, window_s=window_s,
                                call_ms=call_ms, setup_s=None, peak_bytes=0, work=work)
    metrics = {}
    wanted = [(m["name"], m["unit"]) for m in spec.per_layer] + [
        (name, unit) for name, (unit, cells) in SPAN_METRICS.items() if spec.name in cells]
    for name, unit in wanted:
        value = manifest.metric_reader(name)(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    out = {"workload": spec.name, "seed": seed, "metrics": metrics,
           "device": {"kind": torch.cuda.get_device_name(device) if cuda else device.type}}
    breakdown = {}
    if summary is not None:
        out["device"].update(busy_s=summary.busy_s, window_s=summary.window_s,
                             power_limit=run.power_limit())
        breakdown.update(device_ops=summary.device_ops(10),
                         idle_gaps=[[n, s] for n, s in summary.gaps[:10]])
    breakdown.update(device_by_span=attr.top(attr.device_s), idle_by_span=attr.top(attr.idle_s))
    out["breakdown"] = breakdown
    out["about"] = {"window_s": window_s, "calls": calls, "shares": _shares(attr),
                    "spans": attr.spans, "counters": attr.counters}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    spec = manifest.load(args.workload)
    if not torch.cuda.is_available():
        print(f"attribute: {args.workload} needs a CUDA device", file=sys.stderr)
        return 3
    out = traced(spec, args.seed, args.seconds, torch.device("cuda", 0))
    line = json.dumps(out)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
