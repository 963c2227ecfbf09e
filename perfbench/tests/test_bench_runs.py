"""A run of every cell at a tiny size on the CPU: correct as the port
stands, not correct with each fault the cell can have planted under it;
no result without a card."""

import json
import subprocess
import sys

import pytest

from perfbench.bench import manifest
from perfbench.tests.tinycells import CELLS, SEED, run_tiny, tiny
from perfbench.tools import faults

ROOT = manifest.ROOT


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = run_tiny(name)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and out["attempted"] >= 1
    names = {m["name"] for m in manifest.load(name).end_to_end}
    assert {"images_per_s", "setup_s"} <= set(out["metrics"]) <= names


def test_glow_sampling_follows_the_traffic_temperature():
    """The temperature is the traffic file's: the program samples at it and
    the reference follows; served at 0.7 and judged at 1.0 is not correct."""
    import time

    import torch

    from perfbench import run

    spec = tiny("glow-cifar10.sample")
    spec.traffic["temperature"] = 0.7
    out = run.run(spec, SEED, 0.2, False, torch.device("cpu"), start=time.time())
    assert out["correct"], out["checks"]
    cell = run.manifest.entry_module(spec.entry).Cell(spec, SEED, torch.device("cpu"))
    cell.call(0)
    cell.temperature = 1.0
    assert cell.check()["pixel_bin_gap"] > spec.cell["check"]["limits"]["pixel_bin_gap"]


CASES = [(c, f) for c in CELLS for f in faults.FAULTS[manifest.load(c).entry]]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_planted_fault_is_not_correct(name, fault):
    with faults.plant(fault, manifest.load(name).entry):
        out = run_tiny(name)
    assert not out["correct"], out["checks"]


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and not out.stdout.strip()


def test_only_the_benchmark_files_no_result(tmp_path):
    """A checkout of BENCHMARK.json and perfbench/ alone: the program is
    missing, so the run fails and prints nothing."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_on_the_card(name, tmp_path):
    """The control (the program's TF32 path) at the cell's own size fails
    the check on three seeds; card only."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is TF32 on the card")
    path = tmp_path / "r.jsonl"
    out = subprocess.run([sys.executable, "perfbench/tools/readings.py", "--workload", name,
                          "--seeds", "3100000003,3100000007,3100000009", "--calls", "1",
                          "--mode", "control", "--out", str(path)],
                         capture_output=True, text=True, timeout=1800, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    limits = manifest.load(name).cell["check"]["limits"]
    for line in path.read_text().splitlines():
        checks = json.loads(line)["checks"]
        assert any(v > limits[k] for k, v in checks.items()), checks
