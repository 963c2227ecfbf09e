"""trace_window and annotate of nfdpm_tpu_torch/utils/profiling.py on the
CPU (the counterparts of nfdpm_tpu/utils/profiling.py's, over
torch.profiler): the trace file under the log directory, an annotated
region's name in it, nothing written when disabled. The port's spans and
counters: nothing recorded, no clock read and no device touched while off;
nesting, threads and calls while recording; the loader's producer thread;
the spans' clock against the profiler's; the span trees of a Glow sample,
a train step and a two-step DDIM call."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread
from nfdpm_tpu.utils import profiling as jprof
from nfdpm_tpu_torch.utils import profiling as tprof


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _work():
    a = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    return (a @ a).sum()


def _trace_names(log_dir):
    (path,) = log_dir.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    return {e.get("name") for e in events}


def test_trace_window_writes_a_trace_with_the_annotated_region(tmp_path):
    with tprof.trace_window(str(tmp_path / "trace")) as prof:
        assert prof is not None
        with tprof.annotate("nfdpm_region"):
            _work()
    names = _trace_names(tmp_path / "trace")
    assert "nfdpm_region" in names
    assert any(n and "mm" in n for n in names)  # the matmul inside the region


def test_annotate_as_a_decorator(tmp_path):
    @tprof.annotate("nfdpm_decorated")
    def step():
        return _work()

    with tprof.trace_window(str(tmp_path / "trace")):
        step()
    assert "nfdpm_decorated" in _trace_names(tmp_path / "trace")


def test_disabled_trace_window_writes_nothing(tmp_path):
    with tprof.trace_window(str(tmp_path / "trace"), enabled=False) as prof:
        assert prof is None
        _work()
    assert not (tmp_path / "trace").exists()


def test_the_jax_package_has_the_same_two_names():
    import inspect

    for name in ("trace_window", "annotate"):
        assert list(inspect.signature(getattr(tprof, name)).parameters) == list(
            inspect.signature(getattr(jprof, name)).parameters)


# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------

def _boom(*args, **kwargs):
    raise AssertionError("called while spans are off")


def test_spans_off_record_nothing_and_read_no_clock_nor_device():
    assert not tprof._active
    with pytest.MonkeyPatch.context() as m:
        for mod, name in ((time, "time_ns"), (time, "perf_counter_ns"), (time, "perf_counter"),
                          (time, "monotonic_ns"), (torch.cuda, "synchronize"),
                          (torch.profiler, "record_function"), (threading, "get_ident")):
            m.setattr(mod, name, _boom)
        span = tprof.annotate("off.region")
        assert span is tprof.annotate("off.region")  # made once, then shared
        with span:
            with tprof.annotate("off.inner"):
                tprof.count("off.counter")

        @tprof.annotate("off.decorated")
        def f():
            return 7

        assert f() == 7
    assert tprof._recording is None


def test_recording_nests_spans_per_thread_with_parents_and_calls():
    def other():
        with tprof.annotate("other"):
            with tprof.annotate("other.inner"):
                tprof.count("n")

    with tprof.annotate("before"):
        with tprof.recording() as rec:
            with pytest.raises(RuntimeError):
                with tprof.recording():
                    pass
            with tprof.annotate("root"):
                with tprof.annotate("child"):
                    with tprof.annotate("leaf"):
                        tprof.count("n", 2)
                th = threading.Thread(target=other)
                th.start()
                th.join(10)
            assert not th.is_alive()
    with tprof.annotate("after"):
        tprof.count("n")
    by = {s.name: s for s in rec.spans}
    assert sorted(by) == ["child", "leaf", "other", "other.inner", "root"]
    root, child, leaf = by["root"], by["child"], by["leaf"]
    assert (root.parent, child.parent, leaf.parent) == (None, root.id, child.id)
    assert root.call == child.call == leaf.call == root.id
    assert root.start_ns <= child.start_ns <= leaf.start_ns <= leaf.end_ns <= child.end_ns <= root.end_ns
    other, inner = by["other"], by["other.inner"]
    assert other.thread != root.thread and inner.thread == other.thread
    assert (other.parent, inner.parent, other.call, inner.call) == (None, other.id, other.id,
                                                                    other.id)
    assert rec.counters == {"n": 3}
    assert [s.name for s in rec.spans].index("leaf") < [s.name for s in rec.spans].index("root")


def test_the_loaders_spans_and_counters_on_its_producer_thread():
    from nfdpm_tpu_torch.data.pipeline import prefetch_to_device

    def slow():
        for i in range(4):
            time.sleep(0.01)
            yield np.full((2, 4, 4, 3), i, np.float32), np.zeros(2, np.int64)

    with tprof.recording() as rec:
        got = [int(b[0][0, 0, 0, 0]) for b in prefetch_to_device(slow(), torch.device("cpu"))]
    assert got == [0, 1, 2, 3]
    names = [s.name for s in rec.spans]
    assert names.count("loader.copy") == 4 and names.count("loader.assemble") == 5
    assert rec.counters["loader.batches"] == 4
    assert rec.counters["loader.empty_takes"] == names.count("loader.wait") >= 1
    main = threading.get_ident()
    producer = {s.thread for s in rec.spans if s.name.startswith("loader.") and s.name != "loader.wait"}
    assert len(producer) == 1 and main not in producer
    assert {s.thread for s in rec.spans if s.name == "loader.wait"} == {main}


def test_a_span_is_on_the_profilers_host_clock():
    from torch.profiler import ProfilerActivity, profile

    with tprof.recording() as rec, profile(activities=[ProfilerActivity.CPU]) as prof:
        with tprof.annotate("clock.span"):
            with torch.profiler.record_function("clock.inner"):
                _work()
    (span,) = rec.spans
    (inner,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "clock.inner"]
    assert span.start_ns <= inner.start_ns() <= inner.start_ns() + inner.duration_ns() <= span.end_ns


def _tree(rec):
    by_id = {s.id: s for s in rec.spans}
    return by_id, {s.id: (by_id[s.parent].name if s.parent else None) for s in rec.spans}


def _parents(rec, name):
    by_id, parent = _tree(rec)
    return {parent[s.id] for s in rec.spans if s.name == name}


def _glow():
    from nfdpm_tpu_torch.models import glow as tglow
    from nfdpm_tpu_torch.models import prior as tprior

    cfg = tglow.GlowConfig(in_channels=3, levels=2, steps=2, coupling_width=8)
    params = {"flow": tglow.init_glow(0, cfg, "cpu"),
              "prior": tprior.init_gaussian_prior(tglow.final_channels(cfg), True, "cpu")}
    return cfg, params


def test_the_span_tree_of_a_glow_sample():
    from nfdpm_tpu_torch import inference

    cfg, params = _glow()
    sample = inference.make_sample_fn(cfg, 8, device="cpu")
    with tprof.recording() as rec:
        sample(params, 2, generator=torch.Generator().manual_seed(0))
    (root,) = [s for s in rec.spans if s.parent is None]
    assert root.name == "glow.sample" and all(s.call == root.id for s in rec.spans)
    assert _parents(rec, "glow.inverse") == _parents(rec, "quantize.postprocess") == {"glow.sample"}
    assert _parents(rec, "flow.step") == _parents(rec, "glow.split") == {"glow.inverse"}
    for part in ("flow.fold", "flow.mix", "coupling.cnn", "flow.tail"):
        assert _parents(rec, part) == {"flow.step"}
    assert [s.name for s in rec.spans].count("flow.step") == 4


def test_the_span_tree_of_a_train_step():
    from nfdpm_tpu_torch.convert import trainable
    from nfdpm_tpu_torch.training import nf_trainer as tnft

    cfg, params = _glow()
    tcfg = tnft.NFTrainConfig(lr=1e-3)
    tx = tnft.optimizer_of(tcfg)
    params = trainable(params)
    state = {"params": params, "opt_state": tx.init(params), "step": 0}
    step = tnft.make_train_step(cfg, tcfg, tx, inject_noise=True, device="cpu")
    batch = torch.rand(2, 8, 8, 3, generator=torch.Generator().manual_seed(1))
    with tprof.recording() as rec:
        step(state, batch, torch.rand(2, 8, 8, 3, generator=torch.Generator().manual_seed(2)))
    (root,) = [s for s in rec.spans if s.parent is None]
    assert root.name == "nf.train_step"
    for name in ("glow.forward", "nf.backward", "optim.apply"):
        assert _parents(rec, name) == {"nf.train_step"}
    # the CPU runs the backward on the caller's thread: the Functions' spans nest in it
    assert _parents(rec, "flow.mix.bwd") == _parents(rec, "flow.tail.bwd") == {"nf.backward"}
    assert [s.name for s in rec.spans].count("flow.mix.bwd") == 4


def test_the_span_tree_of_a_two_step_ddim_call():
    from nfdpm_tpu_torch import inference
    from nfdpm_tpu_torch.models import formaters
    from nfdpm_tpu_torch.models.diffusion_prior import DiffusionPrior
    from nfdpm_tpu_torch.models.nf_backbone import NFBackbone

    cfg, params = _glow()
    formater = formaters.IdentityFormater(L=2, in_channels=3, size=8)
    dp = DiffusionPrior(formater, {"dim": 8, "dim_mults": (1, 2), "resnet_block_groups": 4},
                        {"timesteps": 20, "sampling_timesteps": 2, "beta_schedule": "cosine",
                         "objective": "pred_noise", "sampling_method": "ddim"})
    sample = inference.make_diffusion_sample_fn(NFBackbone(cfg=cfg, img_size=8), dp, device="cpu")
    tree = {"flow": params["flow"], "diffusion": dp.init_params(0, "cpu")}
    with tprof.recording() as rec:
        sample(tree, 2, generator=torch.Generator().manual_seed(0))
    (root,) = [s for s in rec.spans if s.parent is None]
    assert root.name == "nfdp.sample"
    names = [s.name for s in rec.spans]
    assert names.count("prior.part") == dp.num_parts and names.count("ddim.step") == 2 * dp.num_parts
    assert _parents(rec, "prior.part") == _parents(rec, "glow.inverse") == {"nfdp.sample"}
    assert _parents(rec, "ddim.step") == {"prior.part"}
    assert _parents(rec, "unet") == {"ddim.step"}
    assert _parents(rec, "unet.resnet") == _parents(rec, "unet.linear_attention") == {"unet"}
    assert _parents(rec, "unet.mid_attention") == {"unet"}
