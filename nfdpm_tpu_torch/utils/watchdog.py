"""Step watchdog: detect a hung train step and turn it into a resumable stop.

Counterpart of nfdpm_tpu/utils/watchdog.py (the port keeps its own copy).
A daemon thread is fed a heartbeat by the training loop; when no beat
arrives within `timeout_s` it

  1. dumps every thread's stack (faulthandler) to
     `<run_dir>/watchdog_stall.txt` and the log, the post-mortem of where
     the run was stuck;
  2. with `action="interrupt"`, raises KeyboardInterrupt in the main
     thread, which both trainers catch to write an emergency checkpoint and
     the `mid_epoch.json` resume marker.

`interrupt_main` is delivered at the next bytecode boundary of the main
thread. A step blocked inside a CUDA synchronisation does not return to
Python until the card finishes, so a wedged card gets its stacks dumped at
once but the interrupt only when (if) the call returns; the stall file is
written first and survives either way. The trainers also hold an interrupt
back until the step in flight has returned (their parameters and moments
are updated in place), so the checkpoint always holds whole steps.

Usage (both trainers, `model.training.watchdog_timeout_s`):

    with StepWatchdog(timeout_s=300, run_dir=run_dir, logger=log) as wd:
        for batch in loader:
            state, metrics = train_step(state, batch, seed)
            wd.beat()                              # the step was enqueued
            if step % print_freq == 0:
                loss = float(torch.stack(pending).mean())  # waits for the card
                wd.beat_sync()                     # steps really completed

`timeout_s` must exceed the longest gap between synchronisations in steady
state, about print_freq x the step time; until the first `beat_sync` the
allowance is 10x, for the kernels' build and the first steps.

Under data parallelism every rank runs its own watchdog (`rank` names its
stall file and messages), and the trainers bound the emergency
checkpoint's collectives by the same `timeout_s`: a rank whose peer is
gone raises with its rank's name instead of hanging.
"""

from __future__ import annotations

import contextlib
import faulthandler
import os
import signal
import threading
import time
from typing import Optional


class StepWatchdog:
    """Heartbeat monitor for a training loop (see the module docstring).

    `action`: "interrupt" (default) raises KeyboardInterrupt in the main
    thread after dumping the stacks; "log" only dumps and logs.
    `timeout_s=None` disables it: every method is then a no-op, so call
    sites need no conditionals."""

    def __init__(self, timeout_s: Optional[float], run_dir: Optional[str] = None,
                 logger=None, action: str = "interrupt",
                 poll_s: Optional[float] = None, rank: Optional[int] = None) -> None:
        if action not in ("interrupt", "log"):
            raise ValueError(f"unknown watchdog action: {action!r}")
        self.timeout_s = timeout_s
        self.run_dir = run_dir
        self.logger = logger
        self.action = action
        self.rank = rank
        # a quarter of the timeout keeps detection within 1.25 timeouts;
        # fine enough for the tests' sub-second timeouts
        self.poll_s = poll_s if poll_s is not None else (
            max(0.05, min(5.0, (timeout_s or 1) / 4)))
        self.fired = False
        self.stall_path: Optional[str] = None
        # Until the first beat_sync the allowance is 10x: CUDA launches are
        # asynchronous, so early beat()s prove only that the host enqueued
        # work, while the first metric fetch waits for the kernels' build
        # and the first steps.
        self.first_grace = 10.0
        self._seen_sync = False
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- heartbeat -----------------------------------------------------------
    def beat(self) -> None:
        """Per-step heartbeat: the step was enqueued (not proof that it ran)."""
        self._last_beat = time.monotonic()

    def beat_sync(self) -> None:
        """Heartbeat at a synchronisation point: the caller just read a value
        from the card, so the steps before it completed; ends the grace."""
        self._seen_sync = True
        self._last_beat = time.monotonic()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "StepWatchdog":
        if self.timeout_s is None or self._thread is not None:
            return self
        self._seen_sync = False
        self._last_beat = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="nfdpm-step-watchdog",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "StepWatchdog":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- internals -----------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            age = time.monotonic() - self._last_beat
            limit = self.timeout_s if self._seen_sync else self.timeout_s * self.first_grace
            if age >= limit:
                self._on_stall(age)
                return  # one shot: the recovery (or a kill) takes it from here

    def _on_stall(self, age: float) -> None:
        self.fired = True
        who = "" if self.rank is None else f" on rank {self.rank}"
        msg = f"watchdog: no step heartbeat for {age:.1f}s{who} (timeout {self.timeout_s}s)"
        try:
            if self.run_dir is not None:
                name = ("watchdog_stall.txt" if not self.rank
                        else f"watchdog_stall_rank{self.rank}.txt")
                self.stall_path = os.path.join(self.run_dir, name)
                os.makedirs(self.run_dir, exist_ok=True)
                with open(self.stall_path, "w") as f:
                    f.write(msg + "\n\n")
                    f.flush()
                    # every thread's stack, even while the main thread is
                    # blocked inside a C call
                    faulthandler.dump_traceback(file=f, all_threads=True)
        except OSError:
            pass
        if self.logger is not None:
            self.logger.error(msg + (f"; thread stacks in {self.stall_path}"
                                     if self.stall_path else ""))
        if self.action == "interrupt":
            import _thread

            # lands in the trainers' KeyboardInterrupt handler: emergency
            # checkpoint and mid-epoch resume marker
            _thread.interrupt_main()


@contextlib.contextmanager
def interrupt_after_block():
    """Hold SIGINT (Ctrl-C, or the watchdog's interrupt) back while the
    block runs and raise it as KeyboardInterrupt once the block has ended.
    A train step of the port updates parameters and Adam moments in place,
    so an interrupt inside one could leave half of them updated; around the
    step and the loop's step count, the emergency checkpoint always holds
    whole steps. Off the main thread (where no SIGINT is delivered) it does
    nothing."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    caught = []
    previous = signal.signal(signal.SIGINT, lambda signum, frame: caught.append(signum))
    try:
        yield
    finally:
        signal.signal(signal.SIGINT, previous)
    if caught:
        raise KeyboardInterrupt
