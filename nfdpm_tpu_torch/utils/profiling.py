"""Profiling hooks: a traced code region, named regions in a trace, an
epoch's trace and step times.

Counterpart of nfdpm_tpu/utils/profiling.py (trace_window, annotate,
EpochProfiler, StepTimer), with torch.profiler in place of jax.profiler:

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
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace_window(log_dir: str, enabled: bool = True):
    """torch.profiler trace around a code region: CPU activities and, where
    CUDA is available, CUDA ones, written on exit as a Chrome trace under
    `log_dir` (`<host>_<pid>.<ms>.pt.trace.json`, torch.profiler's
    TensorBoard layout: `tensorboard --logdir log_dir` with the PyTorch
    profiler plugin, or chrome://tracing, Perfetto). Yields the profiler
    (None when not `enabled`, which traces nothing)."""
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
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()


def annotate(name: str):
    """A named region in a profiler trace (torch.profiler.record_function;
    as a context manager or a decorator)."""
    return torch.profiler.record_function(name)


class EpochProfiler:
    """Trace the first `max_steps` steps of epoch `profile_epoch` with
    torch.profiler (CPU and, on a CUDA device, CUDA activities) and write a
    Chrome trace, `<log_dir>/profile/epoch_<E>.pt.trace.json` (open it in
    chrome://tracing or Perfetto). A no-op when `profile_epoch` is None;
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
