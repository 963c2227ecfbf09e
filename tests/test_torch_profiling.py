"""trace_window and annotate of nfdpm_tpu_torch/utils/profiling.py on the
CPU (the counterparts of nfdpm_tpu/utils/profiling.py's, over
torch.profiler): the trace file under the log directory, an annotated
region's name in it, nothing written when disabled."""

import json

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
