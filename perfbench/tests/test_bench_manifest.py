"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

import json
import re

import pytest

from perfbench.bench import manifest

ROOT = manifest.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == TOP
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    cells = 24
    assert (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    assert NAME.match(entry["name"]) and entry["file"].startswith("perfbench/")
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["name"] == entry["name"] and data["source"] == entry["source"]
    assert data["reduced"] == entry["reduced"]
    assert all(NAME.match(k) for k in entry["reduced"])
    assert "assumed" in data


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_entry_and_files(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
    assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    spec = manifest.load(w["name"])
    assert spec.entry in ("glow_train", "glow_sample", "diffusion_sample")
    manifest.entry_module(spec.entry)
    limits = spec.cell["check"]["limits"]
    assert limits and all(v > 0 for v in limits.values())
    names = [m["name"] for m in spec.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and spec.per_layer


def test_pairs_unique_and_every_config_used():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_entry_and_reader(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert callable(manifest.metric_reader(m["name"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if "bound" in m:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_names_unique():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


def test_a_traffic_key_that_no_entry_reads_is_refused(tmp_path):
    """A traffic file holds exactly the keys its entry reads: one that would
    be ignored (a second client, another temperature for the stage-2
    sampler) is refused, and so is one left out."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    traffic = tmp_path / "perfbench" / "traffic"
    manifest.load("glow-cifar10.sample", tmp_path)
    glow = json.loads((traffic / "sample256.json").read_text())
    (traffic / "sample256.json").write_text(json.dumps({**glow, "clients": 4}))
    with pytest.raises(ValueError, match="clients"):
        manifest.load("glow-cifar10.sample", tmp_path)
    ddim = json.loads((traffic / "ddim-sample256.json").read_text())
    (traffic / "ddim-sample256.json").write_text(json.dumps({**ddim, "temperature": 0.7}))
    with pytest.raises(ValueError, match="temperature"):
        manifest.load("nfdp-cifar10.sample", tmp_path)
    del glow["temperature"]
    (traffic / "sample256.json").write_text(json.dumps(glow))
    with pytest.raises(ValueError, match="temperature"):
        manifest.load("glow-cifar10.sample", tmp_path)
