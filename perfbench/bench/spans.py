"""The device time and the idle time of a traced window, each put down to
the port's span (nfdpm_tpu_torch/utils/profiling.py) that launched the work.

The profiler, recording CUDA activity alone, still records the host's
runtime and driver calls (cudaLaunchKernel, cudaMemcpyAsync, ...), each
with the correlation id of the device event it made, its host time on
time.time_ns()'s clock, and its thread as the low 32 bits of the thread's
pthread id (the event's device_resource_id). The spans are on the same
clock. So each device event is put down in three steps:

  1. its correlation id gives the host call that launched it: a time and a
     thread (where one id has several host events, as a lazy module load
     inside the launch, the earliest is the call);
  2. the innermost span open on that thread at that time takes it;
  3. where that thread has no span open (the autograd engine's device
     thread outside the port's backward Functions), the innermost span
     open then on the thread whose outermost open span started first (the
     call in progress: the caller blocked in .backward()) takes it.

A launch with no span open anywhere goes to HARNESS, a device event whose
host call is missing to UNATTRIBUTED. Each idle gap of the device goes to
whoever launched the event that ends it: the host was in that code when the
device ran dry. Given the window's host bounds, the idle before the first
event goes the same way, and the idle after the last one to HARNESS.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

HARNESS = "(harness)"
UNATTRIBUTED = "(unattributed)"

Device = List[Tuple[int, int, int]]           # (start ns, end ns, correlation id)
Launches = Dict[int, Tuple[int, int]]         # correlation id -> (host ns, thread key)


def thread_key(ident: int) -> int:
    """The profiler's id for a thread of threading.get_ident() `ident`: its
    low 32 bits, signed."""
    return ((ident & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def split_events(events: Iterable) -> Tuple[Device, Launches]:
    """The device events (CUDA activity of positive length, not a
    synchronisation, as perfbench/bench/trace.py takes them) and the host
    calls by correlation id, from kineto events (torch.profiler's
    `prof.profiler.kineto_results.events()`)."""
    from torch.autograd import DeviceType

    device: Device = []
    launches: Launches = {}
    for e in events:
        corr = e.correlation_id()
        if e.device_type() == DeviceType.CUDA:
            dur = e.duration_ns()
            if dur > 0 and "Sync" not in e.name():
                device.append((e.start_ns(), e.start_ns() + dur, corr))
        elif corr > 0:
            start = e.start_ns()
            if corr not in launches or start < launches[corr][0]:
                launches[corr] = (start, e.device_resource_id())
    return device, launches


@dataclasses.dataclass
class Attribution:
    device_s: Dict[str, float]        # span name -> device seconds it launched
    idle_s: Dict[str, float]          # span name -> idle seconds it ended
    spans: Dict[str, Dict[str, float]]  # span name -> count, host_ms, self_ms, device_ms, idle_ms
    counters: Dict[str, int]

    def device_seconds(self, names: Sequence[str]) -> float:
        return sum(self.device_s.get(n, 0.0) for n in names)

    def host_ms(self, names: Sequence[str]) -> float:
        return sum(self.spans[n]["host_ms"] for n in names if n in self.spans)

    def count(self, names: Sequence[str]) -> int:
        return sum(int(self.spans[n]["count"]) for n in names if n in self.spans)

    @staticmethod
    def top(table: Dict[str, float], n: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])[:n]]


def _open_at(spans: Sequence, times: Sequence[int]) -> List[Optional[Tuple]]:
    """For each of the sorted `times`, (innermost, outermost) of the spans
    of one thread (sorted by start, properly nested) open at it, or None."""
    out: List[Optional[Tuple]] = []
    stack: list = []
    i = 0
    for t in times:
        while i < len(spans) and spans[i].start_ns <= t:
            s = spans[i]
            i += 1
            while stack and stack[-1].end_ns <= s.start_ns:
                stack.pop()
            stack.append(s)
        while stack and stack[-1].end_ns <= t:
            stack.pop()
        out.append((stack[-1], stack[0]) if stack else None)
    return out


def _owners(device: Device, launches: Launches, spans: Sequence) -> List[str]:
    """The span name (or HARNESS, UNATTRIBUTED) each device event goes to."""
    threads: Dict[int, list] = {}
    for s in spans:
        threads.setdefault(thread_key(s.thread), []).append(s)
    for ss in threads.values():
        ss.sort(key=lambda s: (s.start_ns, -s.end_ns))
    owner = [UNATTRIBUTED] * len(device)
    asked: Dict[int, List[Tuple[int, int]]] = {}
    for i, (_, _, corr) in enumerate(device):
        if corr in launches:
            t, key = launches[corr]
            asked.setdefault(key, []).append((t, i))
    orphans: List[Tuple[int, int, int]] = []  # (t, event, launching thread)
    for key, qs in asked.items():
        qs.sort()
        found = _open_at(threads.get(key, []), [t for t, _ in qs])
        for (t, i), f in zip(qs, found):
            if f is not None:
                owner[i] = f[0].name
            else:
                orphans.append((t, i, key))
    if orphans:
        orphans.sort()
        times = [t for t, _, _ in orphans]
        open_by_thread = {key: _open_at(ss, times) for key, ss in threads.items()}
        for j, (_, i, key) in enumerate(orphans):
            best = None
            for other, found in open_by_thread.items():
                f = found[j]
                if other != key and f is not None and (best is None
                                                       or f[1].start_ns < best[1].start_ns):
                    best = f
            owner[i] = HARNESS if best is None else best[0].name
    return owner


def attribute(device: Device, launches: Launches, spans: Sequence,
              window_ns: Optional[Tuple[int, int]] = None,
              counters: Optional[Dict[str, int]] = None) -> Attribution:
    """Put each device event and each idle gap of `device` down to a span of
    `spans` (utils.profiling.Span records) through `launches`; `window_ns`
    the window's host bounds on time.time_ns()'s clock."""
    device = sorted(device)
    owner = _owners(device, launches, spans)
    device_s: Dict[str, float] = {}
    idle_s: Dict[str, float] = {}

    def add(table, name, ns):
        if ns > 0:
            table[name] = table.get(name, 0.0) + ns * 1e-9

    cur_t = None
    for (s, t, _), name in zip(device, owner):
        add(device_s, name, t - s)
        if cur_t is None:
            if window_ns is not None:
                add(idle_s, name, s - window_ns[0])
            cur_t = t
        elif s > cur_t:
            add(idle_s, name, s - cur_t)
            cur_t = t
        else:
            cur_t = max(cur_t, t)
    if window_ns is not None:
        add(idle_s, HARNESS, window_ns[1] - (window_ns[0] if cur_t is None else cur_t))

    children: Dict[int, int] = {}
    for s in spans:
        if s.parent is not None:
            children[s.parent] = children.get(s.parent, 0) + s.end_ns - s.start_ns
    table: Dict[str, Dict[str, float]] = {}
    for s in spans:
        row = table.setdefault(s.name, {"count": 0, "host_ms": 0.0, "self_ms": 0.0})
        row["count"] += 1
        row["host_ms"] += (s.end_ns - s.start_ns) * 1e-6
        row["self_ms"] += (s.end_ns - s.start_ns - children.get(s.id, 0)) * 1e-6
    for name in set(device_s) | set(idle_s):
        table.setdefault(name, {"count": 0, "host_ms": 0.0, "self_ms": 0.0})
    for name, row in table.items():
        row["device_ms"] = device_s.get(name, 0.0) * 1e3
        row["idle_ms"] = idle_s.get(name, 0.0) * 1e3
    return Attribution(device_s=device_s, idle_s=idle_s, spans=table,
                       counters=dict(counters or {}))


def of_trace(prof, recording, window_ns: Optional[Tuple[int, int]] = None) -> Attribution:
    """The Attribution of a finished torch.profiler session and the
    utils.profiling recording made over the same window."""
    device, launches = split_events(prof.profiler.kineto_results.events())
    return attribute(device, launches, recording.spans, window_ns, recording.counters)
