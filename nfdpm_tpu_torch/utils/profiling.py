"""Profiling hooks: the port's spans and counters, a traced code region,
an epoch's trace and step times.

Counterpart of nfdpm_tpu/utils/profiling.py (trace_window, annotate,
EpochProfiler, StepTimer), with torch.profiler in place of jax.profiler.

Spans and counters. The port opens `annotate(name)` at each layer boundary
(the entry points, the DDIM step, the UNet's blocks, the Glow step's parts,
the backward, the optimizer, the loader) and calls `count(name)` where it
counts events; each name is a fixed string. What they do depends on two
switches, and on nothing else (no environment variable, no config key):

  * `recording()` on: each span appends one `Span` record (name, thread,
    host start and end in ns on time.time_ns(), torch.profiler's host
    clock, the enclosing span on the same thread and the outermost one,
    the call) to the recording's list, and `count` adds to its counters;
  * a trace_window or an EpochProfiler tracing: each span also opens a
    torch.profiler.record_function range of its name, so the operator's
    Chrome trace shows the same regions;
  * both off: `annotate` returns a no-op made once per name, and `count`
    returns; neither allocates, reads a clock, synchronizes nor launches.

    with recording() as rec:
        state, metrics = train_step(state, batch, seed)
    rec.spans     # [Span(id, name, thread, start_ns, end_ns, parent, call)]
    rec.counters  # {"loader.batches": 1, "channel_mix.launches": 24, ...}

The kernels' own launch counters (`channel_mix.launches`, ...) stay on
their wrappers; a recording reports what they counted while it was on
under those names. perfbench/bench/spans.py joins a recording to a device
trace and puts each device second and idle gap down to a span.

Traces and timers:

    with trace_window("/tmp/nfdpm_trace"):
        with annotate("train_step"):
            state, metrics = train_step(state, batch, seed)

    profiler = EpochProfiler(os.path.join(run_dir, "tb"), profile_epoch=2,
                             max_steps=50, device=device)
    timer = StepTimer()
    for epoch in ...:
        profiler.start_epoch(epoch)
        for batch in loader:
            with timer.step():
                state, metrics = train_step(state, batch, seed)
            profiler.step()
        profiler.end_epoch()
        print(timer.summary())

nfdpm_tpu_torch/profiling.py (`profile_call`, device time by kernel of one
call) is a separate tool and stays as it is.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace_window(log_dir: str, enabled: bool = True):
    """torch.profiler trace around a code region: CPU activities and, where
    CUDA is available, CUDA ones, written on exit as a Chrome trace under
    `log_dir` (`<host>_<pid>.<ms>.pt.trace.json`, torch.profiler's
    TensorBoard layout: `tensorboard --logdir log_dir` with the PyTorch
    profiler plugin, or chrome://tracing, Perfetto). Yields the profiler
    (None when not `enabled`, which traces nothing). The port's spans
    show in it as record_function ranges."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        _tracing_by(1)
        try:
            yield prof
        finally:
            _tracing_by(-1)
            if torch.cuda.is_available():
                torch.cuda.synchronize()


class Span(NamedTuple):
    """One span of a recording. `thread` is threading.get_ident() of the
    thread that ran it; `parent` the id of the span it opened in on that
    thread (None for an outermost one) and `call` the id of the outermost
    span open on that thread (its own id when it is outermost)."""
    id: int
    name: str
    thread: int
    start_ns: int
    end_ns: int
    parent: Optional[int]
    call: int


class Recording:
    """What `recording()` gathers: `spans`, in the order they ended, and
    `counters`, by name; at its end the kernels' launches made while it was
    on join the counters under their wrappers' names."""

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._launches = _kernel_launches()

    def _add(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def _close(self) -> None:
        for name, n in _kernel_launches().items():
            if n != self._launches[name]:
                self.counters[name] = n - self._launches[name]


def _kernel_launches() -> Dict[str, int]:
    """The launch counters the kernel wrappers keep, by name."""
    from ..ops.kernels import channel_mix, coupling_tail, fused_linear_attention, step_megakernel

    return {"channel_mix.launches": channel_mix.channel_mix.launches,
            "channel_mix.backward_launches": channel_mix.channel_mix.backward_launches,
            "coupling_tail.launches": coupling_tail.coupling_tail.launches,
            "coupling_tail_bwd.launches": coupling_tail.coupling_tail_bwd.launches,
            "coupling_tail_inverse.launches": coupling_tail.coupling_tail_inverse.launches,
            "fused_linear_attention.launches":
                fused_linear_attention.fused_linear_attention.launches,
            "fused_linear_attention_bwd.launches":
                fused_linear_attention.fused_linear_attention_bwd.launches,
            "step_megakernel_forward.launches":
                step_megakernel.step_megakernel_forward.launches}


_switch = threading.Lock()
_recording: Optional[Recording] = None
_tracing = 0        # trace_window and EpochProfiler sessions open
_active = False     # either of the two: the one flag a span tests when off
_ids = itertools.count(1)
_local = threading.local()


def _tracing_by(n: int) -> None:
    """A trace_window or EpochProfiler session starts (+1) or ends (-1)."""
    global _tracing, _active
    with _switch:
        _tracing += n
        _active = _recording is not None or _tracing > 0


class _Region:
    def __call__(self, fn):
        """As a decorator: each call of `fn` runs inside annotate(name)."""
        name = self.name

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)

        return wrapped


class _Idle(_Region):
    """What annotate returns while nothing records or traces."""

    __slots__ = ("name",)

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


_idle: Dict[str, _Idle] = {}


class _Live(_Region):
    """A span entered while recording or tracing is on."""

    __slots__ = ("name", "rec", "range", "stack", "id", "start")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        self.rec, self.range = _recording, None
        if _tracing:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        if self.rec is not None:
            stack = getattr(_local, "stack", None)
            if stack is None:
                stack = _local.stack = []
            self.stack, self.id = stack, next(_ids)
            stack.append(self)
            self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self.rec is not None:
            end = time.time_ns()
            stack = self.stack
            if stack[-1] is self:
                stack.pop()
            else:  # left out of order (a generator's span closed late)
                stack.remove(self)
            if self.rec is _recording:
                self.rec.spans.append(Span(
                    self.id, self.name, threading.get_ident(), self.start, end,
                    stack[-1].id if stack else None, stack[0].id if stack else self.id))
        if self.range is not None:
            self.range.__exit__(*exc)
        return None


def annotate(name: str):
    """The port's span: a named region of host code, as a context manager
    or a decorator. Recording (`recording()`) keeps a Span record of it;
    tracing (trace_window, EpochProfiler) shows it in the trace as a
    torch.profiler.record_function range; with both off it is a no-op made
    once per name."""
    if _active:
        return _Live(name)
    idle = _idle.get(name)
    if idle is None:
        idle = _idle.setdefault(name, _Idle(name))
    return idle


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` of the recording that is on, if any."""
    rec = _recording
    if rec is not None:
        rec._add(name, n)


@contextlib.contextmanager
def recording():
    """Turn recording on for the block; yields the Recording that gathers
    the spans and counters. One recording at a time: a second raises."""
    global _recording, _active
    rec = Recording()
    with _switch:
        if _recording is not None:
            raise RuntimeError("recording() is already on")
        _recording, _active = rec, True
    try:
        yield rec
    finally:
        with _switch:
            _recording = None
            _active = _tracing > 0
        rec._close()


class EpochProfiler:
    """Trace the first `max_steps` steps of epoch `profile_epoch` with
    torch.profiler (CPU and, on a CUDA device, CUDA activities) and write a
    Chrome trace, `<log_dir>/profile/epoch_<E>.pt.trace.json` (open it in
    chrome://tracing or Perfetto), the port's spans in it as record_function
    ranges. A no-op when `profile_epoch` is None;
    traces at most one epoch a run. A trace that fails to write, or comes
    back without device events, is logged and never fails the run."""

    def __init__(self, log_dir: str, profile_epoch: Optional[int] = None,
                 max_steps: int = 50, device=None, logger=None):
        self.log_dir = log_dir
        self.profile_epoch = profile_epoch
        self.max_steps = max_steps
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.logger = logger
        self.trace_path: Optional[str] = None
        self._prof = None
        self._done = False
        self._n = 0

    def start_epoch(self, epoch: int) -> None:
        if self._done or self.profile_epoch is None or epoch != self.profile_epoch:
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.__enter__()
        _tracing_by(1)
        self._n = 0
        self._epoch = epoch

    def step(self) -> None:
        if self._prof is None:
            return
        self._n += 1
        if self._n >= self.max_steps:
            self._stop()

    def end_epoch(self) -> None:
        if self._prof is not None:
            self._stop()

    def _stop(self) -> None:
        prof, self._prof, self._done = self._prof, None, True
        _tracing_by(-1)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        path = os.path.join(self.log_dir, "profile", f"epoch_{self._epoch:03d}.pt.trace.json")
        try:
            prof.__exit__(None, None, None)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            prof.export_chrome_trace(path)
            self.trace_path = path
        except (OSError, RuntimeError) as e:
            if self.logger is not None:
                self.logger.warning(f"profiler: no trace written for epoch {self._epoch}: {e}")
            return
        if self.logger is not None:
            self.logger.info(f"profiler: {self._n} steps of epoch {self._epoch} traced "
                             f"into {path}")


class StepTimer:
    """Wall-clock time of each step with a percentile summary. CUDA work is
    asynchronous, so by default a step's time is that of its host work (the
    enqueue); `synchronize=device` waits for the card at the end of each
    step instead, which times the step's work and takes away the overlap of
    one step's host work with the previous step's kernels."""

    def __init__(self, synchronize=None) -> None:
        self.durations: List[float] = []
        self._sync = torch.device(synchronize) if synchronize is not None else None

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        if self._sync is not None and self._sync.type == "cuda":
            torch.cuda.synchronize(self._sync)
        self.durations.append(time.perf_counter() - t0)

    def summary(self, skip_warmup: int = 1) -> Dict[str, float]:
        d = np.asarray(self.durations[skip_warmup:] or self.durations)
        if len(d) == 0:
            return {}
        return {"steps": int(len(d)), "mean_ms": float(d.mean() * 1e3),
                "p50_ms": float(np.percentile(d, 50) * 1e3),
                "p95_ms": float(np.percentile(d, 95) * 1e3),
                "max_ms": float(d.max() * 1e3)}
