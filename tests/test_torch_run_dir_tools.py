"""The port's run-directory tools on the CPU, against the JAX package's.

  * nfdpm_tpu_torch.serve --run-dir gives the same bytes as --weights for
    the same parameters (both kinds), and /health reports the run;
  * python -m nfdpm_tpu_torch.generate_samples and
    python -m nfdpm_tpu_torch.interpolate on both kinds print the JSON keys
    of tools/generate_samples.py and tools/interpolate.py and write arrays
    of the same shapes; generate_samples' samples are the server's for the
    same seed;
  * the Glow interpolation strip equals the JAX tool's on the converted run
    at the raw endpoints and the interior lambdas, and within one 5-bit
    level (8 uint8 values) at lambda 0 and 1, whose values sit on bin
    edges; the stage-2 strip, given the draws the JAX tool makes from its
    key, is within one 5-bit level on at most 1e-3 of the pixels.

The run directories are written by the JAX package (orbax, seeded weights:
Glow L2/K2, width 16, 8x8x3; UNets of dim 8, T = 6) and converted with
tools/jax_run_to_torch.py. The entry points' `load.load_batch` runs are in
test_torch_entry.py (stage 1) and test_torch_diffusion_train.py (stage 2).
"""

import http.client
import json
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from _torch_port import (REPO_ROOT, RUN_IMG, one_torch_thread, write_jax_diffusion_run,
                         write_jax_glow_run)
from nfdpm_tpu_torch import convert, generate_samples, interpolate, serve
from nfdpm_tpu_torch.training import checkpoint as tckpt
from nfdpm_tpu_torch.training import runload as trl

sys.path.insert(0, str(REPO_ROOT / "tools"))
sys.path.insert(0, str(REPO_ROOT))
import jax_run_to_torch  # noqa: E402
from tools import generate_samples as jgenerate  # noqa: E402
from tools import interpolate as jinterpolate  # noqa: E402

STEPS = 4  # interpolation lambdas


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{kind: (JAX run dir, converted port run dir)} for "glow", "diffusion"."""
    root = tmp_path_factory.mktemp("tools")
    write_jax_glow_run(root / "glow_jax", epochs=(1, 2))
    write_jax_diffusion_run(root / "diffusion_jax")
    for kind in ("glow", "diffusion"):
        jax_run_to_torch.main(["--run-dir", str(root / f"{kind}_jax"),
                               "--out", str(root / f"{kind}_pt")])
    return {kind: (str(root / f"{kind}_jax"), str(root / f"{kind}_pt"))
            for kind in ("glow", "diffusion")}


@pytest.fixture(scope="module")
def jax_tools(runs, tmp_path_factory):
    """What the JAX tools print and write on the JAX run directories:
    {(tool, kind): (JSON record, arrays)}."""
    out = {}
    for kind in ("glow", "diffusion"):
        jax_dir = runs[kind][0]
        tmp = tmp_path_factory.mktemp(f"jax_{kind}")
        for tool, argv, name in (
                (jgenerate, ["--n", "5", "--batch", "4", "--out", str(tmp / "gen")],
                 "gen/samples.npz"),
                (jinterpolate, ["--steps", str(STEPS), "--out", str(tmp / "interp")],
                 "interp/interp_0_1.npz")):
            record = _main(tool, ["--run-dir", jax_dir, *argv])
            with np.load(tmp / name) as data:
                out[(tool.__name__.split(".")[-1], kind)] = (record, dict(data))
    return out


def _main(tool, argv):
    """Run a tool's main in-process; its one JSON line as a dict."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tool.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _weights_argv(kind, pt_dir, tmp_path, use_ema=True):
    """--weights arguments serving the parameters of the run's newest
    checkpoint (its EMA weights with use_ema)."""
    weights = tmp_path / "weights.npz"
    if kind == "glow":
        params = tckpt.restore_params(pt_dir, "gaussian", 2, "cpu")
        convert.save_npz(weights, convert.to_jax_params(params))
        return ["--weights", str(weights), "--levels", "2", "--steps", "2", "--width", "16",
                "--img-size", str(RUN_IMG)]
    run = trl.load_diffusion_run(pt_dir, use_ema=use_ema, device="cpu")
    convert.save_npz(weights, convert.diffusion_to_jax_params(run.params))
    return ["--weights", str(weights), "--arch", f"{pt_dir}/diffusion_architecture.json"]


@pytest.mark.parametrize("kind", ["glow", "diffusion"])
def test_serve_run_dir_gives_the_weights_bytes(runs, tmp_path, kind):
    _, pt_dir = runs[kind]
    common = ["--device", "cpu", "--batch", "4", "--temperature", "0.8"]
    from_run, info = serve.build_sampler(serve.parse_args(["--run-dir", pt_dir, *common]))
    from_weights, _ = serve.build_sampler(serve.parse_args(
        _weights_argv(kind, pt_dir, tmp_path) + common))
    a, b = from_run(6, 0.8, 7), from_weights(6, 0.8, 7)
    assert a.shape == (6, RUN_IMG, RUN_IMG, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    assert info["run_dir"] == pt_dir and info["epoch"] == (2 if kind == "glow" else 1)
    assert info["kind"] == {"glow": "gaussian", "diffusion": "diffusion"}[kind]
    assert "weights" not in info


def test_serve_run_dir_epoch_and_no_ema(runs, tmp_path):
    glow_dir, diffusion_dir = runs["glow"][1], runs["diffusion"][1]
    common = ["--device", "cpu", "--batch", "4"]
    newest, _ = serve.build_sampler(serve.parse_args(["--run-dir", glow_dir, *common]))
    first, info = serve.build_sampler(serve.parse_args(
        ["--run-dir", glow_dir, "--epoch", "1", *common]))
    assert info["epoch"] == 1 and not np.array_equal(newest(4, 1.0, 3), first(4, 1.0, 3))
    live, info = serve.build_sampler(serve.parse_args(
        ["--run-dir", diffusion_dir, "--no-ema", *common]))
    ema, _ = serve.build_sampler(serve.parse_args(["--run-dir", diffusion_dir, *common]))
    assert info["ema"] is False and not np.array_equal(live(4, 1.0, 3), ema(4, 1.0, 3))
    from_weights, _ = serve.build_sampler(serve.parse_args(
        _weights_argv("diffusion", diffusion_dir, tmp_path, use_ema=False) + common))
    np.testing.assert_array_equal(live(4, 1.0, 3), from_weights(4, 1.0, 3))


def test_serve_run_dir_health_over_http(runs):
    _, pt_dir = runs["diffusion"]
    server = serve.make_server(["--run-dir", pt_dir, "--device", "cpu", "--batch", "4",
                                "--ddim", "2", "--port", "0"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
        conn.request("GET", "/health")
        health = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert health["status"] == "ok" and health["run_dir"] == pt_dir
    assert (health["kind"], health["epoch"], health["sampling_timesteps"]) == ("diffusion", 1, 2)


def test_serve_refuses_two_sources_and_data_parallel(runs, tmp_path):
    _, pt_dir = runs["glow"]
    with pytest.raises(SystemExit):
        serve.parse_args(["--run-dir", pt_dir, "--weights", "x.npz"])
    with pytest.raises(SystemExit):
        serve.parse_args(["--device", "cpu"])
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        serve.parse_args(["--run-dir", pt_dir, "--data-parallel"])


@pytest.mark.parametrize("kind", ["glow", "diffusion"])
def test_generate_samples_matches_the_jax_tool_and_the_server(runs, jax_tools, tmp_path, kind):
    _, pt_dir = runs[kind]
    record = _main(generate_samples, ["--run-dir", pt_dir, "--n", "5", "--batch", "4",
                                      "--seed", "3", "--out", str(tmp_path), "--device", "cpu"])
    want, want_arrays = jax_tools[("generate_samples", kind)]
    assert record.keys() == want.keys()
    assert (record["kind"], record["epoch"], record["shape"]) == (
        want["kind"], want["epoch"], want["shape"]) == (
        record["kind"], record["epoch"], [5, RUN_IMG, RUN_IMG, 3])
    with np.load(tmp_path / "samples.npz") as data:
        samples = data["samples"]
    assert samples.dtype == want_arrays["samples"].dtype == np.uint8
    assert samples.shape == want_arrays["samples"].shape
    assert (tmp_path / "grid.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    sample_images, _ = serve.build_sampler(serve.parse_args(
        ["--run-dir", pt_dir, "--device", "cpu", "--batch", "4"]))
    np.testing.assert_array_equal(samples, sample_images(5, record["temperature"], 3))
    no_npz = _main(generate_samples, ["--run-dir", pt_dir, "--n", "2", "--no-npz",
                                      "--out", str(tmp_path / "grid_only"), "--device", "cpu"])
    assert "npz" not in no_npz and not (tmp_path / "grid_only" / "samples.npz").exists()


def test_glow_interpolation_matches_the_jax_tool(runs, jax_tools, tmp_path):
    _, pt_dir = runs["glow"]
    record = _main(interpolate, ["--run-dir", pt_dir, "--steps", str(STEPS),
                                 "--out", str(tmp_path), "--device", "cpu"])
    want, want_arrays = jax_tools[("interpolate", "glow")]
    assert record.keys() == want.keys()
    assert record["shape"] == want["shape"] == [STEPS + 2, RUN_IMG, RUN_IMG, 3]
    with np.load(tmp_path / "interp_0_1.npz") as data:
        strip, lams = data["strip"], data["lams"]
    np.testing.assert_array_equal(lams, want_arrays["lams"])
    assert strip.dtype == np.uint8
    # the raw endpoints and the interior lambdas: the same bytes; lambda 0
    # and 1 give the endpoints' 5-bit codes back through forward and
    # inverse, and those sit exactly on a bin's lower edge, so a round trip
    # 1e-7 below it lands one 5-bit level (8 uint8 values) lower
    diff = np.abs(strip.astype(int) - want_arrays["strip"].astype(int))
    ends = [1, STEPS]  # lambda 0 and 1; 0 and STEPS + 1 are the raw images
    assert np.delete(diff, ends, axis=0).max() == 0
    assert diff[ends].max() <= 8
    codes = (want_arrays["strip"][[0, STEPS + 1]] // 8 * 8).astype(int)
    assert np.abs(strip[ends].astype(int) - codes).max() <= 8
    assert (tmp_path / "interp_0_1.png").exists()


def _jax_interpolation_noise(seed, dp, steps, t=None):
    """The draws tools/interpolate.py makes from PRNGKey(seed) through
    DiffusionPrior.interpolate_latents (each part's interpolate at `t`,
    default T-1), per part, in the port's order."""
    key = jax.random.PRNGKey(seed)
    noise = []
    for i, ((h, w, c), gd) in enumerate(zip(dp.formater.input_shapes, dp.parts)):
        k_q1, k_q2, k_loop = jax.random.split(jax.random.fold_in(key, i), 3)
        shape = (steps, h, w, c)
        t_last = gd.num_timesteps - 1 if t is None else t
        noise.append([torch.from_numpy(np.array(jax.random.normal(k, shape)))
                      for k in (k_q1, k_q2)] + [
            torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(k_loop, s), shape)))
            for s in range(t_last - 1, -1, -1)])
    return noise


def test_diffusion_interpolation_matches_the_jax_tool(runs, jax_tools, tmp_path):
    """The CLI's outputs have the JAX tool's keys and shapes; the strip,
    given the JAX tool's draws, is the JAX tool's strip."""
    _, pt_dir = runs["diffusion"]
    record = _main(interpolate, ["--run-dir", pt_dir, "--steps", str(STEPS),
                                 "--out", str(tmp_path), "--device", "cpu"])
    want, want_arrays = jax_tools[("interpolate", "diffusion")]
    assert record.keys() == want.keys() and record["shape"] == want["shape"]
    run = trl.load_diffusion_run(pt_dir, device="cpu")
    raw = interpolate.load_endpoint_images(pt_dir, run.img_size, (0, 1))
    np.testing.assert_array_equal(raw, want_arrays["strip"][[0, -1]])
    strip = interpolate.interpolation_strip(
        "diffusion", run, raw, want_arrays["lams"],
        noise=_jax_interpolation_noise(0, run.dp, STEPS))
    expected = want_arrays["strip"][1:-1]
    assert strip.shape == expected.shape and strip.dtype == np.uint8
    diff = np.abs(strip.astype(int) - expected.astype(int))
    assert diff.max() <= 8 and np.mean(diff > 0) <= 1e-3


def test_diffusion_interpolation_at_a_smaller_t_matches_jax(runs, tmp_path):
    """--t shortens the stage-2 chain: the CLI takes it, and the strip at
    t = 3 (of T = 6), given the same draws, is the JAX package's chain of
    each part's GaussianDiffusion.interpolate at t = 3, within one 5-bit
    level on at most 1e-3 of the pixels."""
    import jax.numpy as jnp

    from nfdpm_tpu.ops import quantize as jq
    from nfdpm_tpu.training import runload as jrl

    jax_dir, pt_dir = runs["diffusion"]
    t = 3
    record = _main(interpolate, ["--run-dir", pt_dir, "--steps", str(STEPS), "--t", str(t),
                                 "--out", str(tmp_path), "--device", "cpu"])
    assert record["shape"] == [STEPS + 2, RUN_IMG, RUN_IMG, 3]
    run = trl.load_diffusion_run(pt_dir, device="cpu")
    raw = interpolate.load_endpoint_images(pt_dir, run.img_size, (0, 1))
    lams = np.linspace(0.0, 1.0, STEPS, dtype=np.float32)
    strip = interpolate.interpolation_strip(
        "diffusion", run, raw, lams, noise=_jax_interpolation_noise(0, run.dp, STEPS, t), t=t)

    jrun = jrl.load_diffusion_run(jax_dir)
    key = jax.random.PRNGKey(0)
    x = jq.preprocess(jnp.asarray(raw, jnp.float32) / 255.0, jrun.tcfg.n_bits)
    latents, _ = jrun.backbone.transform(jrun.params["flow"], x)
    lam = jnp.asarray(lams).reshape(STEPS, 1, 1, 1)
    mixed = [diff.interpolate(jrun.params["diffusion"]["parts"][i], jax.random.fold_in(key, i),
                              jnp.repeat(p[:1], STEPS, axis=0),
                              jnp.repeat(p[1:2], STEPS, axis=0), t=t, lam=lam)
             for i, (diff, p) in enumerate(zip(jrun.dp.parts,
                                               jrun.dp.formater.process_latents(latents)))]
    images = jrun.backbone.invert(jrun.params["flow"], jrun.dp.formater.postprocess(mixed))
    expected = np.asarray(jq.postprocess(images, jrun.tcfg.n_bits))
    assert strip.shape == expected.shape and strip.dtype == np.uint8
    diff = np.abs(strip.astype(int) - expected.astype(int))
    assert diff.max() <= 8 and np.mean(diff > 0) <= 1e-3
