"""A new cell, configuration, traffic mix, end-to-end metric and per-layer
metric are added as new files and entries, with no edit to a file that is
there."""

import hashlib
import json
import shutil
import subprocess
import sys

from perfbench.bench import manifest

ROOT = manifest.ROOT

RUN = """
import json, sys, time
sys.path.insert(0, '.')
import torch
from perfbench import run
from perfbench.bench import manifest
from perfbench.tests.tinycells import shrink
spec = shrink(manifest.load('glow-cifar10.sample-b64'))
out = run.run(spec, 5, 0.2, False, torch.device('cpu'), start=time.time())
traced = run.run(spec, 5, 0.2, True, torch.device('cpu'), start=time.time())
print(json.dumps({'per_layer': [m['name'] for m in spec.per_layer],
                  'traffic': spec.traffic['batch'], 'config': spec.config['name'],
                  'correct': out['correct'] and traced['correct'],
                  'metrics': sorted(out['metrics']), 'traced': sorted(traced['metrics'])}))
"""


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "perfbench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_and_a_metric_are_new_files_only(tmp_path):
    repo = tmp_path / "repo"
    for d in ("perfbench", "nfdpm_tpu_torch"):
        shutil.copytree(ROOT / d, repo / d, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", repo)
    before = _digests(repo)
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    b = repo / "perfbench"
    config = json.loads((b / "configs" / "glow-cifar10-L3K16.json").read_text())
    config["name"] = "glow-cifar10-copy"
    (b / "configs" / "glow-cifar10-copy.json").write_text(json.dumps(config))
    traffic = json.loads((b / "traffic" / "sample256.json").read_text())
    traffic["batch"] = 64
    (b / "traffic" / "sample64.json").write_text(json.dumps(traffic))
    (b / "workloads" / "glow-cifar10.sample-b64.json").write_text(
        (b / "workloads" / "glow-cifar10.sample.json").read_text())
    (b / "metrics" / "images_per_call.py").write_text(
        "def read(ctx):\n    return ctx.images / ctx.calls\n")
    (b / "metrics" / "calls_in_window.py").write_text(
        "def read(ctx):\n    return float(ctx.calls)\n")
    bench["configs"].append({"name": "glow-cifar10-copy", "source": config["source"],
                             "file": "perfbench/configs/glow-cifar10-copy.json", "reduced": [],
                             "why": "a test configuration"})
    bench["workloads"].append({"name": "glow-cifar10.sample-b64", "config": "glow-cifar10-copy",
                               "traffic": "sample64", "chips": 1, "why": "a test cell"})
    bench["end_to_end"].append({"name": "images_per_call", "unit": "images", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["glow-cifar10.sample-b64"]})
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "the harness's loop",
                               "moves": "images_per_s", "workloads": ["glow-cifar10.sample-b64"]})
    (repo / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(repo)
    assert all(after[k] == v for k, v in before.items())
    out = subprocess.run([sys.executable, "-c", RUN], capture_output=True, text=True,
                         timeout=600, cwd=repo)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["config"] == "glow-cifar10-copy" and got["traffic"] == 4  # shrunk to 4
    assert got["correct"] and "images_per_call" in got["metrics"]
    assert "calls_in_window" in got["per_layer"] and "calls_in_window" in got["traced"]
