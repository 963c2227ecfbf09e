"""Run directories of the JAX package, converted with
tools/jax_run_to_torch.py, read back by nfdpm_tpu_torch.training.runload and
held against nfdpm_tpu.training.runload on the CPU.

Each JAX run directory is written with the JAX package's own save_state
(orbax) from seeded weights: a Glow (L2/K2, width 16, 8x8x3) at two epochs,
and a Glow with a diffusion prior (IdentityFormater, UNets of dim 8,
[1, 2], 2 groups, T = 6, DDIM-3) whose checkpoint keeps an EMA shadow that
differs from the live UNets. Tolerances: bits/dim 1e-4; injected-noise
flow outputs atol 1e-5; the diffusion chains' latents the repository's
chain tolerance, atol 1e-4 / rtol 1e-5 (tests/test_torch_diffusion.py: an
fp32 chain's x0 prediction multiplies the UNet's rounding by up to
1 / sqrt(alphabar), so a 3-step DDIM chain at T = 6 ends 3.6e-5 apart);
uint8 images at most one 5-bit bin (8 levels) apart on at most 1e-3 of the
pixels.
"""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (REPO_ROOT, RUN_IMG, close, one_torch_thread, t,
                         write_jax_diffusion_run, write_jax_glow_run)
from nfdpm_tpu.models import glow as jglow
from nfdpm_tpu.training import diffusion_trainer as jdt
from nfdpm_tpu.training import nf_trainer as jnft
from nfdpm_tpu.training import runload as jrl
from nfdpm_tpu_torch import convert, inference
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.models.nf_backbone import load_pretrained_flow
from nfdpm_tpu_torch.training import runload as trl

sys.path.insert(0, str(REPO_ROOT / "tools"))
import jax_run_to_torch  # noqa: E402

BATCH = 4
CHAIN_TOL = dict(atol=1e-4, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"glow", "diffusion"}: (JAX run dir, converted port run dir, what the
    JAX run was written from)."""
    root = tmp_path_factory.mktemp("runs")
    glow = write_jax_glow_run(root / "glow_jax", epochs=(1, 2))
    diffusion = write_jax_diffusion_run(root / "diffusion_jax")
    out = {}
    for kind, written in (("glow", glow), ("diffusion", diffusion)):
        jax_run_to_torch.main(["--run-dir", str(root / f"{kind}_jax"),
                               "--out", str(root / f"{kind}_pt")])
        out[kind] = (str(root / f"{kind}_jax"), str(root / f"{kind}_pt"), written)
    return out


def _named(tree):
    return {k: np.asarray(v) for k, v in convert.named_leaves(tree)}


def _images(seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (BATCH, RUN_IMG, RUN_IMG, 3)).astype(np.float32) / 255.0


def _uint8_close(a, b):
    """At most one 5-bit bin (8 levels) apart, on at most 1e-3 of the pixels."""
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    diff = np.abs(a.astype(int) - b.astype(int))
    assert diff.max() <= 8 and np.mean(diff > 0) <= 1e-3


# -- the converted files ---------------------------------------------------------

def test_tool_writes_port_checkpoints_with_optimizer_state(runs):
    jax_dir, pt_dir, _ = runs["glow"]
    for name in ("architecture.json", "config.yaml"):
        assert open(os.path.join(jax_dir, name)).read() == open(os.path.join(pt_dir, name)).read()
    for epoch in (1, 2):
        ckpt = torch.load(os.path.join(pt_dir, "checkpoints", f"model_gaussian_{epoch:03d}.pt"),
                          weights_only=True)
        assert set(ckpt) == {"params", "opt_state", "step"} and ckpt["step"] == 4 * epoch
        assert set(ckpt["opt_state"]) == {"mu", "nu", "count"}
        assert ckpt["opt_state"]["count"] == 0
    jax_dir, pt_dir, _ = runs["diffusion"]
    ckpt = torch.load(os.path.join(pt_dir, "checkpoints", "model_diffusion_001.pt"),
                      weights_only=True)
    assert set(ckpt) == {"params", "opt_state", "step", "ema"} and ckpt["step"] == 9
    assert set(ckpt["params"]) == {"flow", "diffusion"} and set(ckpt["ema"]) == {"diffusion"}
    assert set(ckpt["opt_state"]["mu"]) == {"flow", "diffusion"}
    assert ckpt["opt_state"]["count"] == 0
    assert json.load(open(os.path.join(pt_dir, "diffusion_architecture.json"))) == json.load(
        open(os.path.join(jax_dir, "diffusion_architecture.json")))


# -- Glow runs ------------------------------------------------------------------

@pytest.mark.parametrize("epoch", [None, 1])
def test_glow_run_matches_jax(runs, epoch):
    jax_dir, pt_dir, written = runs["glow"]
    want, got = jrl.load_glow_run(jax_dir, epoch), trl.load_glow_run(pt_dir, epoch, "cpu")
    for field in ("in_channels", "levels", "steps", "coupling_width", "learn_prior",
                  "invconv_param"):
        assert getattr(got.gcfg, field) == getattr(want.gcfg, field), field
    assert (got.tcfg.n_bits, got.tcfg.compat_fixed_prior) == (
        want.tcfg.n_bits, want.tcfg.compat_fixed_prior)
    assert (got.img_size, got.temperature, got.epoch) == (
        want.img_size, want.temperature, want.epoch) == (RUN_IMG, 0.7, epoch or 2)
    back = _named(convert.to_jax_params(got.params))
    for k, v in _named(written[got.epoch]).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_glow_run_bits_per_dim_matches_jax(runs):
    jax_dir, pt_dir, _ = runs["glow"]
    want, got = jrl.load_glow_run(jax_dir), trl.load_glow_run(pt_dir, device="cpu")
    imgs, key, salt = _images(), jax.random.PRNGKey(4), np.int32(2)
    bpd_j = jnft.make_eval_step(want.gcfg, want.tcfg)(
        jax.tree.map(jnp.asarray, want.params), jnp.asarray(imgs), key, salt)
    noise = np.asarray(jax.random.uniform(jax.random.fold_in(key, salt), imgs.shape))
    bpd_t = inference.make_eval_step(got.gcfg, got.tcfg.n_bits, device="cpu")(
        got.params, t(imgs), noise=noise)
    close(bpd_t, bpd_j, atol=1e-4)


def _jax_glow_noise(key, salt, cfg, n):
    """The N(0, 1) draws of nf_trainer.make_sample_fn from (key, salt), in
    latent-part order."""
    k1, k2 = jax.random.split(jax.random.fold_in(key, salt))
    shapes = jglow.latent_shapes_nhwc(cfg, RUN_IMG)
    noise = [None] * len(shapes)
    noise[-1] = jax.random.normal(k1, (n, *shapes[-1]))
    for i in range(cfg.levels - 1):
        noise[-(i + 2)] = jax.random.normal(jax.random.fold_in(k2, i), (n, *shapes[-(i + 2)]))
    return [np.asarray(e) for e in noise]


def test_glow_run_samples_match_jax(runs):
    jax_dir, pt_dir, _ = runs["glow"]
    want, got = jrl.load_glow_run(jax_dir), trl.load_glow_run(pt_dir, device="cpu")
    jparams = jax.tree.map(jnp.asarray, want.params)
    key, salt = jax.random.PRNGKey(7), 1
    imgs_j = np.asarray(jnft.make_sample_fn(want.gcfg, want.tcfg, RUN_IMG)(
        jparams, key, BATCH, want.temperature, salt))
    noise = _jax_glow_noise(key, salt, want.gcfg, BATCH)
    imgs_t = inference.make_sample_fn(got.gcfg, RUN_IMG, got.tcfg.n_bits, "cpu")(
        got.params, BATCH, got.temperature, noise=noise).numpy()
    _uint8_close(imgs_t, imgs_j)
    # the flow's output before quantization, from all latent parts given
    x_j = jglow.inverse(jparams["flow"], want.gcfg, [jnp.asarray(z) for z in noise])
    with torch.inference_mode():
        x_t = tglow.inverse(got.params["flow"], got.gcfg, [t(z) for z in noise])
    close(x_t, np.asarray(x_j), atol=1e-5)


def test_converted_run_is_a_pretrained_flow(runs):
    _, pt_dir, written = runs["glow"]
    backbone, flow = load_pretrained_flow(pt_dir, 2, device="cpu")
    assert backbone.img_size == RUN_IMG and backbone.frozen
    back = _named(convert.to_jax_params({"flow": flow, "prior": {}}))
    for k, v in _named(written[2]).items():
        if k.startswith("flow/"):
            np.testing.assert_array_equal(back[k], v, err_msg=k)


# -- diffusion runs -------------------------------------------------------------

@pytest.mark.parametrize("use_ema", [True, False])
def test_diffusion_run_matches_jax(runs, use_ema):
    """Config fields, and the UNets of the EMA shadow (use_ema) or the live
    ones, equal to what JAX's runload gives."""
    jax_dir, pt_dir, (tree, shadow, _arch) = runs["diffusion"]
    want = jrl.load_diffusion_run(jax_dir, use_ema=use_ema)
    got = trl.load_diffusion_run(pt_dir, use_ema=use_ema, device="cpu")
    assert (got.img_size, got.temperature, got.epoch, got.tcfg.n_bits) == (
        want.img_size, want.temperature, want.epoch, want.tcfg.n_bits)
    assert got.backbone.frozen == want.backbone.frozen
    for field in ("in_channels", "levels", "steps", "coupling_width", "learn_prior"):
        assert getattr(got.backbone.cfg, field) == getattr(want.backbone.cfg, field)
    assert type(got.dp.formater).__name__ == type(want.dp.formater).__name__
    assert got.dp.formater.input_shapes == want.dp.formater.input_shapes
    for a, b in zip(got.dp.parts, want.dp.parts):
        for field in ("timesteps", "sampling_timesteps", "loss_type", "beta_schedule",
                      "ddim_sampling_eta", "sampling_method"):
            assert getattr(a.cfg, field) == getattr(b.cfg, field), field
    unets = _named({"parts": [convert.unet_to_flax(u)
                              for u in got.params["diffusion"]["parts"]]})
    source = (shadow if use_ema else tree)["diffusion"]
    for k, v in _named(source).items():
        np.testing.assert_array_equal(unets[k], v, err_msg=k)
    for k, v in _named(jax.tree.map(np.asarray, want.params["diffusion"])).items():
        np.testing.assert_array_equal(unets[k], v, err_msg=k)


def test_diffusion_overrides_reach_the_prior(runs):
    _, pt_dir, _ = runs["diffusion"]
    got = trl.load_diffusion_run(pt_dir, ddim=2, sampler="dpm++", device="cpu")
    assert all(p.cfg.sampling_timesteps == 2 and p.cfg.sampling_method == "dpm++"
               for p in got.dp.parts)


def _jax_diffusion_noise(key, salt, dp, n):
    """The DDIM chains' draws of diffusion_trainer.make_sample_fn, per part."""
    k_diff, _ = jax.random.split(jax.random.fold_in(key, salt))
    noise = []
    for i, ((h, w, c), gd) in enumerate(zip(dp.formater.input_shapes, dp.parts)):
        k_init, k_loop = jax.random.split(jax.random.fold_in(k_diff, i))
        noise.append([np.asarray(jax.random.normal(k_init, (n, h, w, c)))] + [
            np.asarray(jax.random.normal(jax.random.fold_in(k_loop, s), (n, h, w, c)))
            for s in range(gd.sampling_timesteps)])
    return noise


def test_diffusion_run_samples_match_jax(runs):
    jax_dir, pt_dir, _ = runs["diffusion"]
    want = jrl.load_diffusion_run(jax_dir)
    got = trl.load_diffusion_run(pt_dir, device="cpu")
    jparams = jax.tree.map(jnp.asarray, want.params)
    key, salt = jax.random.PRNGKey(7), 1
    imgs_j = np.asarray(jdt.make_sample_fn(want.backbone, want.dp, want.tcfg)(
        jparams, key, BATCH, 1.0, salt))
    noise = _jax_diffusion_noise(key, salt, want.dp, BATCH)
    sample = inference.make_diffusion_sample_fn(got.backbone, got.dp, got.tcfg.n_bits, "cpu")
    imgs_t, latents_t = sample(got.params, BATCH, noise=noise, return_latents=True)
    _uint8_close(imgs_t.numpy(), imgs_j)
    k_diff, _ = jax.random.split(jax.random.fold_in(key, salt))
    latents_j = want.dp.sample_latents(jparams["diffusion"], k_diff, BATCH)
    for a, b in zip(latents_t, latents_j):
        close(a, np.asarray(b), **CHAIN_TOL)


# -- config.yaml fallbacks, run directory names, mixed formats -------------------

def test_config_yaml_fallbacks_match_jax(runs, tmp_path):
    """A Glow architecture file without "temperature" and a stage-2 run
    without diffusion_architecture.json: both packages read config.yaml."""
    for kind in ("glow", "diffusion"):
        for pkg, src in (("jax", runs[kind][0]), ("pt", runs[kind][1])):
            shutil.copytree(src, tmp_path / f"{kind}_{pkg}")
    for pkg in ("jax", "pt"):
        arch_path = tmp_path / f"glow_{pkg}" / "architecture.json"
        arch = json.loads(arch_path.read_text())
        del arch["temperature"]
        arch_path.write_text(json.dumps(arch))
        (tmp_path / f"diffusion_{pkg}" / "diffusion_architecture.json").unlink()
    want = jrl.load_glow_run(str(tmp_path / "glow_jax"))
    got = trl.load_glow_run(str(tmp_path / "glow_pt"), device="cpu")
    assert got.temperature == want.temperature == 0.7
    want = jrl._diffusion_arch_from_config(str(tmp_path / "diffusion_jax"))
    got = trl._diffusion_arch_from_config(str(tmp_path / "diffusion_pt"))
    assert got == want
    run = trl.load_diffusion_run(str(tmp_path / "diffusion_pt"), device="cpu")
    assert run.backbone.cfg.levels == 2 and run.dp.parts[0].cfg.timesteps == 6


def test_resolve_run_dir_under_outputs(runs, tmp_path, monkeypatch):
    _, pt_dir, _ = runs["glow"]
    (tmp_path / "outputs").mkdir()
    (tmp_path / "outputs" / "nf_run").symlink_to(pt_dir)
    monkeypatch.chdir(tmp_path)
    assert trl.resolve_run_dir("nf_run") == os.path.join("outputs", "nf_run")
    assert trl.resolve_run_dir(pt_dir) == pt_dir
    assert trl.load_glow_run("nf_run", device="cpu").epoch == 2
    with pytest.raises(FileNotFoundError, match="no run dir"):
        trl.resolve_run_dir("missing")
    assert trl.detect_kind("outputs/nf_run") == ("gaussian", 2)


@pytest.mark.parametrize("entries,call", [
    (["model_gaussian_001.pt", "model_diffusion_002/"], "detect_kind"),     # diffusion orbax
    (["model_gaussian_001.pt", "model_gaussian_003/"], "detect_kind"),      # newer orbax
    (["model_gaussian_001.pt", "model_gaussian_003/"], "load_glow_run"),    # newest wanted
    (["model_gaussian_002/"], "load_pretrained_flow"),                      # epoch 2 wanted
], ids=["diffusion-orbax", "newer-orbax", "load-newest", "pretrained-flow"])
def test_orbax_checkpoints_are_refused(runs, tmp_path, entries, call):
    """A directory that holds an orbax checkpoint where the port would read
    one raises, naming the tool that converts it; it never falls back to an
    older checkpoint of the port's."""
    _, pt_dir, _ = runs["glow"]
    shutil.copyfile(os.path.join(pt_dir, "architecture.json"), tmp_path / "architecture.json")
    ckpts = tmp_path / "checkpoints"
    ckpts.mkdir()
    for entry in entries:
        if entry.endswith("/"):
            (ckpts / entry.rstrip("/")).mkdir()
        else:
            shutil.copyfile(os.path.join(pt_dir, "checkpoints", "model_gaussian_001.pt"),
                            ckpts / entry)
    run = {"detect_kind": lambda: trl.detect_kind(str(tmp_path)),
           "load_glow_run": lambda: trl.load_glow_run(str(tmp_path), device="cpu"),
           "load_pretrained_flow": lambda: load_pretrained_flow(str(tmp_path), 2,
                                                                device="cpu")}[call]
    with pytest.raises(NotImplementedError, match="tools/jax_run_to_torch.py"):
        run()
    # the port's own checkpoint is still read when asked for by epoch
    if "model_gaussian_001.pt" in entries:
        assert trl.load_glow_run(str(tmp_path), 1, "cpu").epoch == 1
