"""Rules the PyTorch port keeps, and its server on the CPU.

- nfdpm_tpu_torch/ and chip_smoke.py import neither JAX nor nfdpm_tpu.
- Entry points run on CUDA unless the caller names the CPU; without CUDA
  they raise instead of running on the CPU.
- nfdpm_tpu_torch.serve answers /health and /generate.
"""

import ast
import http.client
import io
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import nfdpm_tpu_torch
from nfdpm_tpu_torch import convert, inference, serve
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.models import prior as tprior

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "nfdpm_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tools" / "profile_torch_serving.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "nfdpm_tpu")


def _forbidden(module: str) -> bool:
    """True for jax... or nfdpm_tpu(.x) — but not for nfdpm_tpu_torch."""
    return module.split(".")[0] in FORBIDDEN


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_forbidden_matches_module_names_exactly():
    assert _forbidden("jax") and _forbidden("jax.numpy") and _forbidden("nfdpm_tpu.ops")
    assert not _forbidden("nfdpm_tpu_torch") and not _forbidden("nfdpm_tpu_torch.ops")
    assert not _forbidden("jaxtyping_like")


@pytest.mark.parametrize("path", PORT_FILES, ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_file_imports_no_jax_or_reference_package(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print('\\n'.join(sorted(sys.modules)))"],
                         cwd=REPO, capture_output=True, text=True, check=True, timeout=120)
    return set(out.stdout.split())


def test_fresh_interpreter_loads_no_jax_or_reference_modules():
    bare = _modules_after("")
    loaded = _modules_after("import nfdpm_tpu_torch.serve, nfdpm_tpu_torch.inference")
    assert "nfdpm_tpu_torch.serve" in loaded and "torch" in loaded
    new_bad = sorted(m for m in loaded - bare if _forbidden(m))
    assert not new_bad, new_bad


def test_resolve_device_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        nfdpm_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        nfdpm_tpu_torch.resolve_device("cuda")
    assert nfdpm_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    cfg = tglow.GlowConfig(levels=2, steps=1, coupling_width=8)
    for entry in (lambda: inference.make_eval_step(cfg),
                  lambda: inference.make_sample_fn(cfg, 8),
                  lambda: tglow.init_glow(0, cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()


def test_entry_points_turn_tf32_off():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    inference.make_sample_fn(tglow.GlowConfig(levels=2, steps=1, coupling_width=8), 8,
                             device="cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.fixture
def cpu_server(tmp_path):
    cfg = tglow.GlowConfig(levels=2, steps=1, coupling_width=16)
    params = {"flow": tglow.init_glow(0, cfg, "cpu"),
              "prior": tprior.init_gaussian_prior(tglow.final_channels(cfg), True, "cpu")}
    weights = tmp_path / "glow.npz"
    convert.save_npz(weights, convert.to_jax_params(params))
    server = serve.make_server(["--weights", str(weights), "--device", "cpu",
                                "--levels", "2", "--steps", "1", "--width", "16",
                                "--img-size", "8", "--batch", "4", "--port", "0"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def _request(server, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body))
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _samples(body: bytes) -> np.ndarray:
    with np.load(io.BytesIO(body)) as data:
        return data["samples"]


def test_serve_health_and_generate_on_cpu(cpu_server):
    status, _, body = _request(cpu_server, "GET", "/health")
    info = json.loads(body)
    assert status == 200 and info["status"] == "ok" and info["device"] == "cpu"
    assert info["levels"] == 2 and info["batch"] == 4

    status, headers, body = _request(cpu_server, "POST", "/generate", {"n": 6, "seed": 7})
    assert status == 200
    assert float(headers["X-Generation-Seconds"]) >= 0
    assert float(headers["X-Samples-Per-Sec"]) > 0
    first = _samples(body)
    assert first.shape == (6, 8, 8, 3) and first.dtype == np.uint8
    _, _, again = _request(cpu_server, "POST", "/generate", {"n": 6, "seed": 7})
    np.testing.assert_array_equal(_samples(again), first)
    _, _, other = _request(cpu_server, "POST", "/generate", {"n": 6, "seed": 8})
    assert not np.array_equal(_samples(other), first)


@pytest.mark.parametrize("path,body,code", [
    ("/generate", {"seed": 1}, 400),          # n missing
    ("/generate", {"n": 0}, 400),             # n out of range
    ("/generate", {"n": 2, "seed": -1}, 400),
    ("/generate", {"n": 2, "format": "gif"}, 400),
    ("/nowhere", {"n": 2}, 404),
])
def test_serve_rejects_bad_requests(cpu_server, path, body, code):
    status, _, _ = _request(cpu_server, "POST", path, body)
    assert status == code


def test_serve_png_grid(cpu_server):
    pytest.importorskip("PIL")
    status, headers, body = _request(cpu_server, "POST", "/generate",
                                     {"n": 3, "format": "png"})
    assert status == 200 and headers["Content-Type"] == "image/png"
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    grid = serve.image_grid(np.zeros((3, 8, 8, 3), np.uint8))
    assert grid.shape == (10, 28, 3)
