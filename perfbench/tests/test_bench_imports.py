"""Nothing the harness runs loads JAX or the JAX package, top-level names
compared whole (nfdpm_tpu_torch begins with nfdpm_tpu and is the program);
the reference imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from perfbench.bench import manifest

ROOT = manifest.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "nfdpm_tpu"}

RUN_EVERY_CELL = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench import run
from perfbench.tests.tinycells import CELLS, run_tiny
import perfbench.tools.readings, perfbench.tools.faults
for name in CELLS:
    run_tiny(name)
print(json.dumps(sorted(sys.modules)))
"""


def _top(name: str) -> str:
    return name.split(".")[0]


def test_a_run_of_every_cell_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", RUN_EVERY_CELL.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not {m for m in loaded if _top(m) in FORBIDDEN}
    assert "nfdpm_tpu_torch" in {_top(m) for m in loaded}


def test_the_forbidden_check_compares_whole_names():
    from perfbench import run

    sys.modules.setdefault("nfdpm_tpu_torch_probe", type(sys)("nfdpm_tpu_torch_probe"))
    try:
        assert "nfdpm_tpu_torch_probe" not in run.forbidden_modules()
    finally:
        del sys.modules["nfdpm_tpu_torch_probe"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "perfbench" / "reference").glob("*.py"))
    assert files
    for f in files:
        tops = {_top(m) for m in _imports(f)}
        assert not tops & (FORBIDDEN | {"nfdpm_tpu_torch"}), f
    out = subprocess.run([sys.executable, "-c", (
        "import sys, json; sys.path.insert(0, %r); "
        "import perfbench.reference.glow, perfbench.reference.unet, "
        "perfbench.reference.diffusion, perfbench.reference.train; "
        "print(json.dumps(sorted(sys.modules)))") % str(ROOT)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    loaded = {_top(m) for m in json.loads(out.stdout.strip().splitlines()[-1])}
    assert not loaded & (FORBIDDEN | {"nfdpm_tpu_torch"})
