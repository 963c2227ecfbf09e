"""Device time and idle gaps put down to the port's spans
(perfbench/bench/spans.py) on hand-made kineto events, the five readers
that read them, and, on the card, a launch attributed through its
correlation id on the profiler's own clock."""

import threading
import time
import types

import pytest
import torch
from torch.autograd import DeviceType

from nfdpm_tpu_torch.utils.profiling import Span
from perfbench.bench import manifest, spans
from perfbench.tests.tinycells import SEED, tiny

MAIN, AUTOGRAD, PRODUCER = 0x7F3A_D855_9740, 0x7F3A_1234_5600, 0x7F39_0000_0700


def _event(name, start, dur, corr, device=DeviceType.CUDA, thread=0):
    return types.SimpleNamespace(name=lambda: name, start_ns=lambda: start,
                                 duration_ns=lambda: dur, correlation_id=lambda: corr,
                                 device_type=lambda: device,
                                 device_resource_id=lambda: spans.thread_key(thread))


def _launch(corr, t, thread, name="cudaLaunchKernel"):
    return _event(name, t, 5, corr, DeviceType.CPU, thread)


SPANS = [Span(1, "nf.train_step", MAIN, 0, 1000, None, 1),
         Span(3, "flow.mix", MAIN, 100, 200, 1, 1),
         Span(2, "nf.backward", MAIN, 500, 900, 1, 1),
         Span(4, "flow.mix.bwd", AUTOGRAD, 600, 700, None, 4),
         Span(5, "loader.assemble", PRODUCER, 550, 950, None, 5)]

EVENTS = [
    _launch(11, 150, MAIN), _event("channel_mix_f32", 160, 20, 11),
    _launch(11, 250, MAIN, "Lazy Function Loading"),          # a later event of the launch
    _launch(12, 650, AUTOGRAD), _event("channel_mix_f32", 660, 30, 12),
    _launch(13, 750, AUTOGRAD), _event("conv_dgrad", 760, 40, 13),  # autograd, no span open
    _launch(14, 1100, MAIN), _event("Memcpy DtoH", 1110, 10, 14),  # outside every span
    _event("orphan", 1200, 10, 15),                                 # no launch recorded
    _event("cudaStreamSynchronize", 1000, 50, 16),                  # a synchronisation: left out
]


def _attribution():
    device, launches = spans.split_events(EVENTS)
    return spans.attribute(device, launches, SPANS, window_ns=(0, 1300),
                           counters={"loader.batches": 3})


def test_each_event_and_gap_goes_to_the_span_that_launched_it():
    a = _attribution()
    s = 1e-9
    assert a.device_s == pytest.approx({"flow.mix": 20 * s, "flow.mix.bwd": 30 * s,
                                        "nf.backward": 40 * s, spans.HARNESS: 10 * s,
                                        spans.UNATTRIBUTED: 10 * s})
    # lead 0-160, gaps 180-660, 690-760, 800-1110, 1120-1200, tail 1210-1300
    assert a.idle_s == pytest.approx({"flow.mix": 160 * s, "flow.mix.bwd": 480 * s,
                                      "nf.backward": 70 * s, spans.HARNESS: (310 + 90) * s,
                                      spans.UNATTRIBUTED: 80 * s})
    assert sum(a.device_s.values()) + sum(a.idle_s.values()) == pytest.approx(1300 * s)


def test_the_span_table_counts_host_and_self_time():
    a = _attribution()
    step = a.spans["nf.train_step"]
    assert step["count"] == 1 and step["host_ms"] == pytest.approx(1000e-6)
    assert step["self_ms"] == pytest.approx((1000 - 100 - 400) * 1e-6)
    assert step["device_ms"] == 0.0
    assert a.spans["flow.mix.bwd"]["device_ms"] == pytest.approx(30e-6)
    assert a.spans[spans.HARNESS]["idle_ms"] == pytest.approx(400e-6)
    assert a.counters == {"loader.batches": 3}
    assert a.top(a.idle_s, 2)[0][0] == "flow.mix.bwd"


def test_a_thread_is_known_by_the_low_32_bits_of_its_id():
    assert spans.thread_key(0x7F3A_D855_9740) == 0xD8559740 - 2 ** 32
    assert spans.thread_key(0x7F3A_1234_5600) == 0x12345600


def _ctx(name, attribution, calls=2):
    spec = tiny(name)
    work = {"flow": (1000, 10), "attention": (2000, 20), "steps": 1}
    return types.SimpleNamespace(spec=spec, spans=attribution, calls=calls, work=work)


def _synthetic(names_ms):
    """An Attribution with one span per (name, host ms, device ms)."""
    recs, device, launches = [], [], {}
    t = 0
    for i, (name, host_ms, dev_ms) in enumerate(names_ms, start=1):
        end = t + int(host_ms * 1e6)
        recs.append(Span(i, name, MAIN, t, end, None, i))
        launches[i] = (t + 1, spans.thread_key(MAIN))
        device.append((t + 2, t + 2 + int(dev_ms * 1e6), i))
        t = end + 10
    return spans.attribute(device, launches, recs)


def test_the_five_readers():
    from perfbench.bench import peaks
    from perfbench.cost.flow_spans import mix_weight_grad_work

    read = manifest.metric_reader
    a = _synthetic([("nf.train_step", 30.0, 0.0), ("nf.train_step", 50.0, 0.0),
                    ("flow.mix", 1.0, 0.5), ("flow.tail", 1.0, 0.25), ("flow.mix.bwd", 1.0, 0.25),
                    ("unet.linear_attention", 1.0, 0.4), ("optim.apply", 2.0, 1.5),
                    ("loader.assemble", 3.0, 0.0), ("loader.copy", 1.0, 0.0),
                    ("loader.assemble", 5.0, 0.0), ("loader.copy", 3.0, 0.0)])
    train = _ctx("glow-cifar10.train", a)
    assert read("host_ms_per_call")(train) == pytest.approx(40.0)
    assert read("loader_producer_ms_per_batch")(train) == pytest.approx(6.0)
    assert read("optimizer_span_device_ms_per_step")(train) == pytest.approx(0.75)
    extra = mix_weight_grad_work(train.spec.config, train.spec.traffic["batch"])
    least, _ = peaks.least_seconds(2 * (1000 + extra[0]), 2 * (10 + extra[1]))
    assert read("flow_span_roofline")(train) == pytest.approx(100 * least / 1e-3)
    least, _ = peaks.least_seconds(2 * 2000, 2 * 20)
    assert read("attention_span_roofline")(train) == pytest.approx(100 * least / 0.4e-3)


def test_the_readers_read_nothing_without_spans():
    empty = spans.attribute([], {}, [])
    for name in ("host_ms_per_call", "flow_span_roofline", "attention_span_roofline",
                 "optimizer_span_device_ms_per_step", "loader_producer_ms_per_batch"):
        ctx = _ctx("glow-cifar10.train", empty)
        assert manifest.metric_reader(name)(ctx) is None
        del ctx.spans  # perfbench/run.py's ctx has no spans
        assert manifest.metric_reader(name)(ctx) is None


def test_the_tool_records_a_tiny_cells_spans_on_the_cpu():
    from perfbench.tools import attribute

    out = attribute.traced(tiny("glow-cifar10.train"), SEED, 0.05, torch.device("cpu"))
    table = out["about"]["spans"]
    assert table["nf.train_step"]["count"] == out["about"]["calls"]
    assert {"nf.backward", "optim.apply", "flow.mix.bwd", "loader.copy"} <= set(table)
    assert {"host_ms_per_call", "loader_producer_ms_per_batch"} <= set(out["metrics"])


@pytest.mark.cuda
def test_a_launch_goes_to_its_span_through_its_correlation_id_on_the_card():
    """A kernel launched in a span, on the main thread and on another, is put
    down to that span, and the device's times lie on the spans' clock; card
    only."""
    from torch.profiler import ProfilerActivity, profile

    from nfdpm_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the launches and device events are the card's")
    x = torch.randn(2048, 2048, device="cuda")
    x @ x
    torch.cuda.synchronize()

    def other():
        with profiling.annotate("probe.thread"):
            x @ x

    with profiling.recording() as rec, profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.annotate("probe.main"):
            x @ x
        torch.cuda.synchronize()
        synced = time.time_ns()
        t = threading.Thread(target=other)
        t.start()
        t.join(60)
        torch.cuda.synchronize()
    assert not t.is_alive()
    device, launches = spans.split_events(prof.profiler.kineto_results.events())
    a = spans.attribute(device, launches, rec.spans)
    assert a.device_s.get("probe.main", 0) > 0 and a.device_s.get("probe.thread", 0) > 0
    assert spans.UNATTRIBUTED not in a.device_s
    main = next(s for s in rec.spans if s.name == "probe.main")
    ran = [(s, e) for s, e, corr in device if main.start_ns <= launches[corr][0] <= main.end_ns]
    # launched inside the span on time_ns's clock, and run on the device
    # after the launch and before the synchronisation returned, on the same clock
    assert ran and all(main.start_ns <= s and e <= synced for s, e in ran)
