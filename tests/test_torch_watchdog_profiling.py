"""The port's hung-step watchdog and profiler hooks on the CPU: the
counterparts of tests/test_utils.py's TestWatchdog, StepTimer and
TestEpochProfiler, and both wired into the stage-1 trainer (a loader that
stalls turns into an emergency checkpoint; profile_epoch writes a trace).
"""

import json
import logging
import time

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread
from nfdpm_tpu_torch.data.pipeline import read_dataset
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.training import checkpoint as tckpt
from nfdpm_tpu_torch.training import nf_trainer as tnft
from nfdpm_tpu_torch.utils.profiling import EpochProfiler, StepTimer
from nfdpm_tpu_torch.utils.watchdog import StepWatchdog, interrupt_after_block


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


class TestWatchdog:
    def test_fires_dumps_stacks(self, tmp_path):
        """No heartbeat within the timeout: fired, and every thread's stack
        in <run_dir>/watchdog_stall.txt (observe-only action)."""
        wd = StepWatchdog(0.1, run_dir=str(tmp_path), action="log", poll_s=0.02)
        with wd:
            wd.beat_sync()
            time.sleep(0.5)
        assert wd.fired
        dump = (tmp_path / "watchdog_stall.txt").read_text()
        assert "no step heartbeat" in dump and "Thread" in dump

    def test_first_sync_grace(self, tmp_path):
        """Until the first beat_sync the allowance is 10x the timeout; beat()
        refreshes the clock but does not end the grace, beat_sync() does."""
        wd = StepWatchdog(0.15, run_dir=str(tmp_path), action="log", poll_s=0.02)
        with wd:
            wd.beat()
            time.sleep(0.45)  # 3x the timeout, before any sync: no fire
            assert not wd.fired
            wd.beat_sync()
            time.sleep(0.45)
        assert wd.fired

    def test_interrupt_action_reaches_main_thread(self, tmp_path):
        """action="interrupt" lands a KeyboardInterrupt in the main thread,
        the trainers' emergency-checkpoint path."""
        with pytest.raises(KeyboardInterrupt):
            with StepWatchdog(0.1, run_dir=str(tmp_path), poll_s=0.02) as wd:
                wd.beat_sync()
                for _ in range(200):  # delivered at a bytecode boundary
                    time.sleep(0.05)   # between these sleeps
        assert wd.fired

    def test_disabled_is_noop(self):
        wd = StepWatchdog(None)
        with wd:
            wd.beat()
        assert wd._thread is None and not wd.fired

    def test_unknown_action_raises(self):
        with pytest.raises(ValueError, match="unknown watchdog action"):
            StepWatchdog(1.0, action="kill")


def test_interrupt_after_block_holds_sigint_until_the_block_ends():
    import _thread

    done = []
    with pytest.raises(KeyboardInterrupt):
        with interrupt_after_block():
            _thread.interrupt_main()
            time.sleep(0.05)  # a bytecode boundary where it would have landed
            done.append(True)
    assert done == [True]
    with interrupt_after_block():  # nothing caught: nothing raised
        done.append(True)
    assert done == [True, True]


class TestProfiling:
    def test_step_timer_summary(self):
        timer = StepTimer()
        for _ in range(5):
            with timer.step():
                time.sleep(0.001)
        s = timer.summary()
        assert s["steps"] == 4  # the first step is skipped as warm-up
        assert s["p50_ms"] >= 1.0 and s["p95_ms"] >= s["p50_ms"]

    def test_step_timer_synchronize_on_the_cpu_is_plain_wall_time(self):
        timer = StepTimer(synchronize="cpu")
        with timer.step():
            time.sleep(0.002)
        assert StepTimer().summary() == {} and timer.summary()["steps"] == 1
        assert timer.durations[0] >= 0.002


class TestEpochProfiler:
    def test_traces_one_epoch_into_tb(self, tmp_path):
        """The profiler traces exactly its target epoch, at most max_steps
        steps, into <run_dir>/tb/profile/ as a Chrome trace."""
        p = EpochProfiler(str(tmp_path / "tb"), profile_epoch=2, max_steps=3)
        x = torch.ones(64)
        for epoch in (1, 2, 3):
            p.start_epoch(epoch)
            for _ in range(5):
                x = torch.tanh(x * 2 + 1)
                p.step()
            p.end_epoch()
        traces = list((tmp_path / "tb").glob("profile/*.pt.trace.json"))
        assert [t.name for t in traces] == ["epoch_002.pt.trace.json"]
        assert p.trace_path == str(traces[0])
        events = json.loads(traces[0].read_text())["traceEvents"]
        assert sum(e.get("name") == "aten::tanh" for e in events) == 3

    def test_disabled_writes_nothing(self, tmp_path):
        p = EpochProfiler(str(tmp_path / "tb"), profile_epoch=None)
        p.start_epoch(1)
        p.step()
        p.end_epoch()
        assert not (tmp_path / "tb").exists() and p.trace_path is None


# -- wired into the trainer ------------------------------------------------------

CFG = tglow.GlowConfig(in_channels=3, levels=2, steps=1, coupling_width=16)


def _loaders():
    return read_dataset("synthetic", "", batch_size=8, img_size=8, synthetic_n=48)


class _StallBefore:
    """Loader proxy whose epochs hang before batch n: a minute of short
    sleeps, so that the interrupt finds a bytecode boundary to land on (a
    thread blocked in one long C call takes it only when the call returns)."""

    def __init__(self, loader, n):
        self._loader, self._n = loader, n

    def __getattr__(self, name):
        return getattr(self._loader, name)

    def __len__(self):
        return len(self._loader)

    def iter_epoch(self, epoch, start_batch=0):
        for i, item in enumerate(self._loader.iter_epoch(epoch, start_batch=start_batch)):
            if start_batch + i == self._n:
                for _ in range(1200):
                    time.sleep(0.05)
            yield item


def test_a_stalled_loader_becomes_an_emergency_checkpoint(tmp_path, caplog):
    loaders = _loaders()
    loaders = type(loaders)(train=_StallBefore(loaders.train, 3), val=loaders.val,
                            test=loaders.test, eval=loaders.eval)
    tcfg = tnft.NFTrainConfig(epochs=1, print_freq=1, save_checkpoint_freq=50,
                              watchdog_timeout_s=1.0)
    t0 = time.perf_counter()
    with caplog.at_level("WARNING", logger="test_watchdog"), pytest.raises(KeyboardInterrupt):
        tnft.train(cfg=CFG, tcfg=tcfg, loaders=loaders, run_dir=str(tmp_path),
                   logger=logging.getLogger("test_watchdog"), img_size=8, device="cpu")
    assert time.perf_counter() - t0 < 30
    assert "no step heartbeat" in (tmp_path / "watchdog_stall.txt").read_text()
    assert tckpt.load_mid_epoch_marker(str(tmp_path)) == {
        "prefix": "gaussian", "epoch": 1, "batch_in_epoch": 3}
    assert "Watchdog stall: emergency checkpoint at epoch 1 batch 3" in caplog.text
    assert tckpt.restore_state(str(tmp_path), "gaussian", 1, "cpu")["step"] == 3


def test_trainer_profiles_its_epoch_and_logs_step_times(tmp_path, caplog):
    tcfg = tnft.NFTrainConfig(epochs=2, print_freq=100, save_checkpoint_freq=50,
                              profile_epoch=2, profile_steps=2, watchdog_timeout_s=60.0)
    with caplog.at_level("INFO", logger="test_profile"):
        out = tnft.train(cfg=CFG, tcfg=tcfg, loaders=_loaders(), run_dir=str(tmp_path),
                         logger=logging.getLogger("test_profile"), img_size=8, device="cpu")
    assert out["state"]["step"] == 12
    traces = list((tmp_path / "tb" / "profile").glob("*.pt.trace.json"))
    assert [t.name for t in traces] == ["epoch_002.pt.trace.json"]
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert "aten::conv2d" in names
    assert caplog.text.count("step p50 ") == 2 and "profiler: 2 steps of epoch 2" in caplog.text
    assert not (tmp_path / "watchdog_stall.txt").exists()
    assert np.isfinite(out["results"]["bpd_test"])
