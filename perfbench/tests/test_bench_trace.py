"""The reduction of a device trace to what the per-layer metrics read, on
hand-made CUDA events."""

import types

import pytest
from torch.autograd import DeviceType

from perfbench.bench import trace


def _event(name, start_us, dur_us, device=DeviceType.CUDA):
    return types.SimpleNamespace(name=lambda: name, start_ns=lambda: start_us * 1000,
                                 duration_ns=lambda: dur_us * 1000, device_type=lambda: device)


def _prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


def test_busy_is_the_union_and_gaps_are_named_by_what_ends_them():
    events = [_event("conv_a", 0, 100), _event("conv_a", 50, 100),   # overlap: 0-150
              _event("Memcpy DtoH", 400, 50),                          # gap 250
              _event("adam", 460, 40),                                 # gap 10
              _event("cudaStreamSynchronize", 500, 900),               # left out
              _event("host op", 0, 5000, device=DeviceType.CPU)]       # left out
    s = trace.summarize(_prof(events), window_s=0.001)
    assert s.window_s == 0.001
    assert s.busy_s == pytest.approx(240e-6)
    assert s.launches == 3 and s.kernels["conv_a"] == (2, pytest.approx(200e-6))
    assert s.copies == {"Memcpy DtoH": (1, pytest.approx(50e-6))}
    assert s.gaps == [("before Memcpy DtoH", pytest.approx(250e-6)),
                      ("before adam", pytest.approx(10e-6))]
    assert s.device_ops(2) == [["conv_a", pytest.approx(200e-6)],
                               ["Memcpy DtoH", pytest.approx(50e-6)]]


def test_no_device_activity_gives_no_summary():
    assert trace.summarize(_prof([_event("host op", 0, 10, device=DeviceType.CPU)]), 1.0) is None
