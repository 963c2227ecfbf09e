"""The device trace of a traced window, read from torch.profiler's raw
CUDA events, and what the per-layer metrics take from it.

The profiler records CUDA activity alone: recording the host's operators
as well doubles a train step's host time, and the per-layer metrics would
then measure the profiler. The profiled region holds the window and
nothing else (set-up has synchronized before it, the window synchronizes
at its end), so every device event of the trace is the window's; the
window's length is the host clock's. Device activity is every CUDA event
(kernels, copies and fills); `busy_s` is the length of their union.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .groups import group_of


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[int, float]]  # name -> (launches, device seconds)
    copies: Dict[str, Tuple[int, float]]
    gaps: List[Tuple[str, float]]          # the longest idle gaps, by the event that ends them

    @property
    def launches(self) -> int:
        return sum(n for n, _ in self.kernels.values())

    def seconds_of(self, keys: Sequence[str]) -> float:
        """Device seconds of the kernels whose name holds one of `keys`."""
        return sum(s for name, (_, s) in self.kernels.items() if any(k in name for k in keys))

    def group_seconds(self, groups: Sequence[str]) -> float:
        """Device seconds of the kernels and copies in `groups` (groups.GROUPS)."""
        return sum(s for name, (_, s) in {**self.kernels, **self.copies}.items()
                   if group_of(name) in groups)

    def device_ops(self, top: int = 10) -> List[list]:
        every = {**self.kernels, **self.copies}
        ranked = sorted(every.items(), key=lambda kv: -kv[1][1])[:top]
        return [[name[:120], s] for name, (_, s) in ranked]


def _is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def summarize(prof, window_s: float) -> Optional[Summary]:
    """The Summary of a finished torch.profiler session over a window of
    `window_s` host seconds, or None where it holds no device activity."""
    from torch.autograd import DeviceType

    device: List[Tuple[int, int, str]] = []
    for e in prof.profiler.kineto_results.events():
        dur = e.duration_ns()
        if e.device_type() == DeviceType.CUDA and dur > 0 and "Sync" not in e.name():
            device.append((e.start_ns(), e.start_ns() + dur, e.name()))
    if not device:
        return None
    device.sort()
    kernels: Dict[str, List[float]] = {}
    copies: Dict[str, List[float]] = {}
    for s, t, n in device:
        acc = (copies if _is_copy(n) else kernels).setdefault(n, [0, 0.0])
        acc[0] += 1
        acc[1] += (t - s) * 1e-9
    busy, gaps = _union(device)
    return Summary(window_s=window_s, busy_s=busy * 1e-9,
                   kernels={k: (int(v[0]), v[1]) for k, v in kernels.items()},
                   copies={k: (int(v[0]), v[1]) for k, v in copies.items()},
                   gaps=_longest(gaps))


def _union(events: List[Tuple[int, int, str]]):
    """(busy ns, idle gaps [(ns, name of the event that ends the gap)]) of
    events sorted by start."""
    busy, gaps = 0, []
    cur_s, cur_t = None, None
    for s, t, name in events:
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                busy += cur_t - cur_s
                gaps.append((s - cur_t, name))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    busy += cur_t - cur_s
    return busy, gaps


def _longest(gaps: List[Tuple[int, str]], top: int = 10) -> List[Tuple[str, float]]:
    """The `top` longest idle gaps, each named "before <event>" by the device
    event that ends it (what the host was launching), summed by name."""
    named: Dict[str, float] = {}
    for ns, name in sorted(gaps, reverse=True)[:top]:
        key = f"before {name[:113]}"
        named[key] = named.get(key, 0.0) + ns * 1e-9
    return sorted(named.items(), key=lambda kv: -kv[1])
