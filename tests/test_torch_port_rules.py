"""Rules the PyTorch port keeps, and its server on the CPU.

- nfdpm_tpu_torch/ and chip_smoke.py import neither JAX nor nfdpm_tpu.
- Entry points run on CUDA unless the caller names the CPU; without CUDA
  they raise instead of running on the CPU. A data-parallel launch that
  wants NCCL without CUDA raises instead of dropping to one process or to
  gloo on the CPU.
- nfdpm_tpu_torch.serve answers /health and /generate, for a Glow and for a
  Glow with a diffusion prior (--weights; --run-dir in
  test_torch_run_dir_tools.py).
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

from _torch_port import one_torch_thread
import nfdpm_tpu_torch
from nfdpm_tpu_torch import convert, inference, run_baseline, run_diffusion_prior, serve
from nfdpm_tpu_torch.models import formaters as tfmt
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.models import nf_backbone
from nfdpm_tpu_torch.models import prior as tprior
from nfdpm_tpu_torch.models.diffusion_prior import DiffusionPrior
from nfdpm_tpu_torch.models.nf_backbone import NFBackbone
from nfdpm_tpu_torch.training import checkpoint as tckpt
from nfdpm_tpu_torch.training import diffusion_trainer as tdt
from nfdpm_tpu_torch.training import nf_trainer as tnft


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "nfdpm_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"] + [REPO / "tools" / f"profile_{name}.py" for name in (
        "torch_serving", "linear_attention", "step_megakernel")]
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
    modules = ("nfdpm_tpu_torch.serve", "nfdpm_tpu_torch.inference",
               "nfdpm_tpu_torch.profiling", "nfdpm_tpu_torch.models.unet",
               "nfdpm_tpu_torch.models.diffusion", "nfdpm_tpu_torch.models.diffusion_prior",
               "nfdpm_tpu_torch.models.formaters", "nfdpm_tpu_torch.models.nf_backbone",
               "nfdpm_tpu_torch.ops.kernels.fused_linear_attention",
               "nfdpm_tpu_torch.run_baseline", "nfdpm_tpu_torch.training.nf_trainer",
               "nfdpm_tpu_torch.run_diffusion_prior",
               "nfdpm_tpu_torch.training.diffusion_trainer",
               "nfdpm_tpu_torch.training.optim", "nfdpm_tpu_torch.training.checkpoint",
               "nfdpm_tpu_torch.training.tracking", "nfdpm_tpu_torch.data.datasets",
               "nfdpm_tpu_torch.data.pipeline", "nfdpm_tpu_torch.utils.config",
               "nfdpm_tpu_torch.utils.env", "nfdpm_tpu_torch.metrics.compute",
               "nfdpm_tpu_torch.metrics.fid", "nfdpm_tpu_torch.metrics.image_quality",
               "nfdpm_tpu_torch.metrics.inception", "nfdpm_tpu_torch.metrics.clip_features",
               "nfdpm_tpu_torch.metrics.precompute_stats",
               "nfdpm_tpu_torch.training.runload", "nfdpm_tpu_torch.utils.watchdog",
               "nfdpm_tpu_torch.utils.profiling", "nfdpm_tpu_torch.generate_samples",
               "nfdpm_tpu_torch.interpolate", "nfdpm_tpu_torch.utils.reference_import",
               "nfdpm_tpu_torch.utils.reference_export", "nfdpm_tpu_torch.utils.unet_import",
               "nfdpm_tpu_torch.convert_reference_checkpoint",
               "nfdpm_tpu_torch.export_reference_checkpoint",
               "nfdpm_tpu_torch.parallel.distributed", "nfdpm_tpu_torch.parallel.mesh",
               "nfdpm_tpu_torch.parallel.sharding_rules", "nfdpm_tpu_torch.parallel.zero",
               "nfdpm_tpu_torch.parallel.part_parallel", "nfdpm_tpu_torch.ops.draws")
    loaded = _modules_after("import " + ", ".join(modules))
    assert set(modules) <= loaded and "torch" in loaded
    new_bad = sorted(m for m in loaded - bare if _forbidden(m))
    assert not new_bad, new_bad


def test_data_parallel_never_falls_back_to_one_process_or_the_cpu(monkeypatch, tmp_path):
    """NCCL (the default backend) wanted without CUDA raises, under a launch
    named by torchrun's variables or by the arguments, and so does NCCL
    with device=cpu; no process group is left behind. Without a launch
    nothing starts. `serve --data-parallel` without --device and without
    CUDA raises."""
    import torch.distributed as dist

    from nfdpm_tpu_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                "NFDPM_NUM_PROCESSES", distributed.BACKEND_ENV):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False  # no launch, one process
    init = f"file://{tmp_path / 'rendezvous'}"
    with pytest.raises(RuntimeError, match="NCCL backend needs CUDA"):
        distributed.initialize(world_size=2, rank=0, init_method=init)
    with pytest.raises(RuntimeError, match="NCCL backend needs CUDA"):
        distributed.initialize(world_size=2, rank=0, init_method=init, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(RuntimeError, match="NCCL backend needs CUDA"):
        distributed.initialize()
    monkeypatch.setenv(distributed.BACKEND_ENV, "gloo")
    with pytest.raises(RuntimeError, match="rank 1: no CUDA device"):
        distributed.initialize()  # gloo named, but the device is CUDA's
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build_sampler(serve.parse_args(["--weights", "unused.npz", "--data-parallel"]))


def test_resolve_device_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        nfdpm_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        nfdpm_tpu_torch.resolve_device("cuda")
    assert nfdpm_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    cfg = tglow.GlowConfig(levels=2, steps=1, coupling_width=8)
    tcfg = tnft.NFTrainConfig()
    tx = tnft.optimizer_of(tcfg)
    for entry in (lambda: inference.make_eval_step(cfg),
                  lambda: inference.make_sample_fn(cfg, 8),
                  lambda: tglow.init_glow(0, cfg),
                  lambda: tnft.init_train_state(0, cfg, tcfg, tx),
                  lambda: tnft.make_train_step(cfg, tcfg, tx),
                  lambda: tnft.make_eval_step(cfg, tcfg),
                  lambda: tnft.train(cfg=cfg, tcfg=tcfg, loaders=None, run_dir="unused",
                                     logger=None),
                  lambda: tckpt.restore_params("unused", "gaussian", 1),
                  lambda: run_baseline.main(["data.name=synthetic"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()


# a small stage-2 model: Glow L2/K1/w16 at 8x8x3, UNets of dim 8 over the
# latent parts (4,4,6) and (2,2,24), T = 10, DDIM-5
STAGE2_FLOW = dict(L=2, K=1, in_channels=3, coupling_width=16, learn_prior=True,
                   invconv_param="plu", img_size=8)
STAGE2_UNET = dict(dim=8, dim_mults=[1, 2], resnet_block_groups=2)
STAGE2_DIFFUSION = dict(timesteps=10, sampling_timesteps=5, beta_schedule="cosine",
                        ddim_sampling_eta=1.0, vlb_time_chunk=4)


def _stage2(formater="IdentityFormater"):
    cfg = tglow.GlowConfig(levels=2, steps=1, coupling_width=16)
    fmt = tfmt.get_formater(formater)(L=2, in_channels=3, size=8)
    dp = DiffusionPrior(fmt, dict(STAGE2_UNET, dim_mults=(1, 2)), dict(STAGE2_DIFFUSION))
    return cfg, NFBackbone(cfg=cfg, img_size=8), dp


def test_stage2_entry_points_never_fall_back_to_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, backbone, dp = _stage2()
    flow = tglow.init_glow(0, cfg, "cpu")
    tcfg = tdt.DiffusionTrainConfig()
    tx = tdt.make_two_group_optimizer(tcfg, True)
    for entry in (lambda: inference.make_diffusion_sample_fn(backbone, dp),
                  lambda: inference.make_vlb_eval_step(backbone, dp),
                  lambda: dp.init_params(0),
                  lambda: tdt.init_train_state(0, backbone, flow, dp, tx),
                  lambda: tdt.make_train_step(backbone, dp, tcfg, tx),
                  lambda: tdt.train(backbone=backbone, flow_params=flow, dp=dp, tcfg=tcfg,
                                    loaders=None, run_dir="unused", logger=None),
                  lambda: nf_backbone.load_pretrained_flow(str(tmp_path), 1),
                  lambda: run_diffusion_prior.main(["data.name=synthetic"]),
                  lambda: serve.make_server(["--weights", str(tmp_path / "none.npz"),
                                             "--arch", str(tmp_path / "none.json")])):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()


def test_run_dir_tools_never_fall_back_to_cpu(monkeypatch, tmp_path):
    from nfdpm_tpu_torch import generate_samples, interpolate
    from nfdpm_tpu_torch.training import runload

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "checkpoints").mkdir()
    for entry in (lambda: runload.load_glow_run(str(tmp_path)),
                  lambda: runload.load_diffusion_run(str(tmp_path)),
                  lambda: generate_samples.main(["--run-dir", str(tmp_path)]),
                  lambda: interpolate.main(["--run-dir", str(tmp_path)]),
                  lambda: serve.make_server(["--run-dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()


@pytest.mark.parametrize("entry", ["sample", "vlb"])
def test_stage2_entry_points_turn_tf32_off(entry):
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    _, backbone, dp = _stage2()
    make = (inference.make_diffusion_sample_fn if entry == "sample"
            else inference.make_vlb_eval_step)
    make(backbone, dp, device="cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_entry_points_turn_tf32_off():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    inference.make_sample_fn(tglow.GlowConfig(levels=2, steps=1, coupling_width=8), 8,
                             device="cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_training_entry_points_turn_tf32_off():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    tcfg = tnft.NFTrainConfig()
    tnft.make_train_step(tglow.GlowConfig(levels=2, steps=1, coupling_width=8), tcfg,
                         tnft.optimizer_of(tcfg), device="cpu")
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


@pytest.fixture(scope="module")
def stage2_files(tmp_path_factory):
    """(weights .npz, architecture JSON) of a seeded small stage-2 model."""
    tmp = tmp_path_factory.mktemp("stage2")
    cfg, _, dp = _stage2()
    params = {"flow": tglow.init_glow(0, cfg, "cpu"), "prior": {},
              "diffusion": dp.init_params(0, "cpu")}
    weights, arch = tmp / "diffusion.npz", tmp / "diffusion_architecture.json"
    convert.save_npz(weights, convert.diffusion_to_jax_params(params))
    arch.write_text(json.dumps({
        "kind": "diffusion_prior", "flow": STAGE2_FLOW, "formater": "IdentityFormater",
        "formater_stats": None, "unet_kwargs": STAGE2_UNET,
        "diffusion_kwargs": STAGE2_DIFFUSION, "frozen": True, "n_bits": 5,
        "temperature": 1.0}))
    return ["--weights", str(weights), "--arch", str(arch), "--device", "cpu",
            "--batch", "4", "--port", "0"]


@pytest.fixture(scope="module")
def cpu_diffusion_server(stage2_files):
    server = serve.make_server(stage2_files)
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


def test_diffusion_serve_health_and_generate_on_cpu(cpu_diffusion_server):
    status, _, body = _request(cpu_diffusion_server, "GET", "/health")
    info = json.loads(body)
    assert status == 200 and info["status"] == "ok" and info["device"] == "cpu"
    assert info["kind"] == "diffusion" and info["levels"] == 2 and info["batch"] == 4
    assert info["sampling_method"] == "auto" and info["sampling_timesteps"] == 5

    status, headers, body = _request(cpu_diffusion_server, "POST", "/generate",
                                     {"n": 6, "seed": 7})
    assert status == 200
    assert float(headers["X-Samples-Per-Sec"]) > 0
    first = _samples(body)
    assert first.shape == (6, 8, 8, 3) and first.dtype == np.uint8
    _, _, again = _request(cpu_diffusion_server, "POST", "/generate", {"n": 6, "seed": 7})
    np.testing.assert_array_equal(_samples(again), first)
    _, _, other = _request(cpu_diffusion_server, "POST", "/generate", {"n": 6, "seed": 8})
    assert not np.array_equal(_samples(other), first)


@pytest.mark.parametrize("path,body,code", [
    ("/generate", {"seed": 1}, 400),
    ("/generate", {"n": 0}, 400),
    ("/generate", {"n": 2, "seed": -1}, 400),
    ("/generate", {"n": 2, "format": "gif"}, 400),
    ("/nowhere", {"n": 2}, 404),
])
def test_diffusion_serve_rejects_bad_requests(cpu_diffusion_server, path, body, code):
    status, _, _ = _request(cpu_diffusion_server, "POST", path, body)
    assert status == code


def test_diffusion_serve_sampler_overrides(stage2_files):
    """--ddim and --sampler reach the prior, as in tools/serve.py."""
    sample_images, info = serve.build_sampler(serve.parse_args(
        stage2_files + ["--ddim", "3", "--sampler", "dpm++"]))
    assert info["sampling_method"] == "dpm++" and info["sampling_timesteps"] == 3
    a, b = sample_images(3, 1.0, 5), sample_images(3, 1.0, 5)
    assert a.shape == (3, 8, 8, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    with pytest.raises(SystemExit):
        serve.parse_args(stage2_files + ["--sampler", "euler"])
