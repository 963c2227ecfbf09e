"""The stage-1 entry point of nfdpm_tpu_torch, end to end on the CPU, and
the port's own copies of the data pipeline against the JAX package's.

    python -m nfdpm_tpu_torch.run_baseline device=cpu data.name=synthetic ...

trains a tiny Glow (L2/K1, coupling width 16, 8x8x3, batch 8, 64 synthetic
images, one epoch) in a subprocess, then `phase=eval` reads the run
directory back; in-process, the same with FID or KID and SSIM/PSNR
configured. Without `device=cpu` and without CUDA the entry point refuses
to start.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import (interrupt_loaders_after, metric_overrides, one_torch_thread,
                         precompute_stats)
from nfdpm_tpu.data import datasets as jdata
from nfdpm_tpu.data import pipeline as jpipe
from nfdpm_tpu_torch import run_baseline
from nfdpm_tpu_torch.data import datasets as tdata
from nfdpm_tpu_torch.data import pipeline as tpipe
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.utils import config as tconfig
from nfdpm_tpu_torch.utils import env as tenv


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


REPO = Path(__file__).resolve().parents[1]
SMALL = ["data.name=synthetic", "data.synthetic_fallback=true", "data.batch_size=8",
         "data.img_size=8", "data.synthetic_n=64", "model.architecture.L=2",
         "model.architecture.K=1", "model.architecture.coupling_width=16",
         "model.training.epochs=1", "model.training.save_checkpoint_freq=1",
         "model.training.print_freq=4"]


def _cli(cwd, *overrides, check=True):
    out = subprocess.run([sys.executable, "-m", "nfdpm_tpu_torch.run_baseline", *overrides],
                         cwd=cwd, capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
                              "NFDPM_NO_TENSORBOARD": "1", "OMP_NUM_THREADS": "1"})
    if check and out.returncode != 0:
        raise AssertionError(out.stdout[-2000:] + out.stderr[-2000:])
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(cwd, run dir name, stdout) of one tiny training run on the CPU."""
    cwd = tmp_path_factory.mktemp("entry")
    out = _cli(cwd, "device=cpu", "experiment_name=nf_entry", *SMALL)
    (run_dir,) = (cwd / "outputs").iterdir()
    return cwd, run_dir.name, out.stdout


def _final(stdout, prefix=""):
    return {split: float(re.search(rf"{prefix}{split} bpd: ([0-9.]+)", stdout).group(1))
            for split in ("test", "train")}


def test_train_phase_writes_the_run_directory(trained):
    cwd, name, stdout = trained
    run_dir = cwd / "outputs" / name
    assert "Data-dependent actnorm initialization done" in stdout
    assert "Device: cpu" in stdout and "torch version" in stdout
    arch = json.loads((run_dir / "architecture.json").read_text())
    assert arch["L"] == 2 and arch["K"] == 1 and arch["coupling_width"] == 16
    assert arch["img_size"] == 8 and arch["fixed_prior"] is True
    assert (run_dir / "checkpoints" / "model_gaussian_001.pt").exists()
    assert (run_dir / "config.yaml").exists() and (run_dir / "train.log").exists()
    bpds = [float(m) for m in re.findall(r"iter \d+: bpd ([0-9.]+)", stdout)]
    assert len(bpds) == 2 and bpds[1] < bpds[0]
    final = _final(stdout, "final ")
    assert all(np.isfinite(v) and 0 < v < 10 for v in final.values())
    assert list((run_dir / "results").glob("checkpoint_samples_e1_s8.png"))


def test_eval_phase_reproduces_the_final_bits_per_dim(trained):
    cwd, name, stdout = trained
    out = _cli(cwd, "device=cpu", "phase=eval", f"load.load_exp_dir={name}",
               "load.load_epoch=1", *SMALL)
    assert _final(out.stdout) == _final(stdout, "final ")
    tight = _cli(cwd, "device=cpu", "phase=eval", f"load.load_exp_dir={name}",
                 "load.load_epoch=1", "model.evaluation.bpd_dequant_samples=3",
                 "model.evaluation.bpd_iwae=true", *SMALL)
    assert "(K=3, iwae)" in tight.stdout
    for split, single in _final(stdout, "final ").items():
        value = float(re.search(rf"{split} bpd \(K=3, iwae\): ([0-9.]+)",
                                tight.stdout).group(1))
        # a tighter bound in expectation; other draws, so allow their spread
        assert value < single + 0.05


def test_without_cuda_the_entry_point_refuses_to_start(tmp_path):
    out = _cli(tmp_path, *SMALL, check=False)
    assert out.returncode != 0
    assert "no CUDA device is available; pass device='cpu'" in out.stderr
    assert not (tmp_path / "outputs").exists()  # refused before anything was written


@pytest.mark.parametrize("override,match", [
    ("model.evaluation.metrics.FID.mode=[clean]", None),  # needs a model name too: no metric
    # a model axis in one process without a launch cannot be built (the id is
    # the case's name from before the data axis was ported, when the message
    # named "multi-GPU"). Spatial partitioning's case keeps its id from
    # before it was ported; it now holds its guard, which needs no launch,
    # with the JAX package's message: at 8x8 over L=2 the deepest level has
    # 2 rows, 1 a rank at model 2. The pipeline's cases keep their ids from
    # before it was ported; they now hold its guards, with the JAX package's
    # messages: K over the stages, the microbatches, fsdp, spatial, an
    # explicit use_pallas=true
    pytest.param("parallel.n_model=2", "n_model=2 does not divide the 1 processes",
                 id="parallel.n_model=2-multi-GPU"),
    pytest.param("parallel.spatial=true parallel.n_model=2",
                 r"parallel.spatial needs \(img_size/2\^L\)/n_model >= 2 and divisible; "
                 r"got 8/2\^2=2 over model=2",
                 id="parallel.spatial=true-parameter partitioning, pipeline and spatial"),
    pytest.param("parallel.pipeline=true parallel.n_model=2", "needs K \\(1\\) divisible by the "
                 "model-axis size \\(2\\)",
                 id="parallel.pipeline=true-parameter partitioning, pipeline and spatial"),
    pytest.param("parallel.pipeline_microbatches=4 parallel.fsdp=true",
                 "pipeline \\+ fsdp both repartition the flow params — enable at most one",
                 id="parallel.pipeline_microbatches=4-parameter partitioning, pipeline and spatial"),
    ("parallel.pipeline=true parallel.spatial=true", "both use the \"model\" axis — enable at "
     "most one"),
    ("parallel.pipeline=true model.architecture.use_pallas=true", "pallas"),
    ("parallel.pipeline_microbatches=-1 parallel.n_model=2 model.architecture.K=2",
     "pipeline_microbatches must be >= 1, got -1"),
    ("phase=bogus", "phase must be"),
])
def test_refused_options_raise(tmp_path, monkeypatch, override, match):
    monkeypatch.chdir(tmp_path)
    argv = ["device=cpu", *SMALL, "model.training.epochs=0", *override.split()]
    if match is None:
        run_baseline.main(argv)  # a mode without a model names no metric
        return
    with pytest.raises((NotImplementedError, ValueError), match=match):
        run_baseline.main(argv)


@pytest.mark.parametrize("option", ["load.load_batch", "model.training.watchdog_timeout_s",
                                    "model.training.profile_epoch",
                                    "model.architecture.coupling_dtype", "parallel.fsdp",
                                    "parallel.spatial"])
def test_accepted_options_do_their_job(tmp_path, monkeypatch, caplog, option):
    """The options the port once refused: `load.load_batch` resumes an
    interrupted epoch (to the uninterrupted run's final bits/dim exactly),
    the watchdog trains without firing, `profile_epoch` writes the epoch's
    trace, `coupling_dtype=bfloat16` trains the flow with bf16 coupling CNNs
    (other bits/dim than fp32's, finite) and `phase=eval` with it gives the
    run's final bits/dim again; `parallel.fsdp=true` with
    `parallel.n_slices=1` in one process (no launch: one rank, nothing to
    partition) trains exactly as without (two ranks:
    tests/test_torch_parallel_cli.py); `parallel.spatial=true` without a
    model axis warns as the JAX package does and trains exactly as without
    (two ranks: tests/test_torch_spatial.py)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("NFDPM_NO_TENSORBOARD", "1")
    argv = ["device=cpu", *SMALL]
    full = run_baseline.main(argv + ["experiment_name=full"])
    if option == "load.load_batch":
        restore = interrupt_loaders_after(monkeypatch, 5)
        with pytest.raises(KeyboardInterrupt):
            run_baseline.main(argv + ["experiment_name=cut"])
        restore()
        (cut,) = (tmp_path / "outputs").glob("cut_*")
        assert json.loads((cut / "checkpoints" / "mid_epoch.json").read_text()) == {
            "prefix": "gaussian", "epoch": 1, "batch_in_epoch": 5}
        out = run_baseline.main(argv + ["experiment_name=resumed",
                                        f"load.load_exp_dir={cut.name}", "load.load_epoch=1",
                                        "load.load_batch=5"])
        assert out["results"] == full["results"]
        assert (Path(out["run_dir"]) / "checkpoints" / "model_gaussian_001.pt").exists()
        assert not (Path(out["run_dir"]) / "checkpoints" / "mid_epoch.json").exists()
    elif option == "model.training.watchdog_timeout_s":
        out = run_baseline.main(argv + ["experiment_name=wd", f"{option}=300"])
        assert out["results"] == full["results"]
        assert not (Path(out["run_dir"]) / "watchdog_stall.txt").exists()
    elif option == "model.architecture.coupling_dtype":
        seen = []
        forward = tglow.forward
        monkeypatch.setattr(tglow, "forward",
                            lambda p, cfg, *a, **k: seen.append(cfg.compute_dtype)
                            or forward(p, cfg, *a, **k))
        out = run_baseline.main(argv + ["experiment_name=bf16", f"{option}=bfloat16"])
        assert seen and set(seen) == {torch.bfloat16}
        assert all(np.isfinite(v) for v in out["results"].values())
        assert out["results"] != full["results"]
        evaluated = run_baseline.main(argv + [
            "experiment_name=bf16_eval", "phase=eval", "load.load_epoch=1",
            f"load.load_exp_dir={Path(out['run_dir']).name}", f"{option}=bfloat16"])
        assert evaluated["results"] == out["results"]
    elif option == "parallel.spatial":
        with caplog.at_level("WARNING", logger="base"):
            out = run_baseline.main(argv + ["experiment_name=spatial", f"{option}=true"])
        assert out["results"] == full["results"]
        assert ("parallel.spatial=true has no effect without a model axis — set "
                "parallel.n_model>1") in caplog.text
    elif option == "parallel.fsdp":
        out = run_baseline.main(argv + ["experiment_name=fsdp", f"{option}=true",
                                        "parallel.n_slices=1"])
        assert out["results"] == full["results"]
    else:
        out = run_baseline.main(argv + ["experiment_name=prof", f"{option}=1",
                                        "model.training.profile_steps=2"])
        trace = Path(out["run_dir"]) / "tb" / "profile" / "epoch_001.pt.trace.json"
        assert out["results"] == full["results"] and trace.stat().st_size > 0


@pytest.mark.parametrize("metric", ["FID", "KID"])
def test_configured_metrics_run(tmp_path, monkeypatch, caplog, metric):
    """FID or KID in both modes and SSIM/PSNR: at the checkpoint epoch and
    the end of `train`, then in phase=eval, under the JAX package's keys,
    finite; phase=eval samples what training's final evaluation sampled
    (same weights, seed and salts), so its FID/KID are the same."""
    precompute_stats(monkeypatch, tmp_path / "stats", 8)
    monkeypatch.chdir(tmp_path)
    argv = ["device=cpu", *SMALL, *metric_overrides(metric)]
    with caplog.at_level("INFO", logger="base"):
        trained = run_baseline.main(argv + ["experiment_name=metrics"])
    keys = {f"{metric}_inception", f"{metric}_clean_inception", "SSIM", "PSNR"}
    final = trained["results"]["metrics"]
    assert set(final) == keys and all(np.isfinite(v) for v in final.values())
    # the checkpoint epoch's evaluation, then the final one
    assert caplog.text.count("epoch 1 metrics: {") == 2
    evaluated = run_baseline.main(argv + [
        "experiment_name=metrics_eval", "phase=eval", "load.load_epoch=1",
        f"load.load_exp_dir={Path(trained['run_dir']).name}"])["results"]["metrics"]
    assert set(evaluated) == keys and all(np.isfinite(v) for v in evaluated.values())
    for key in keys - {"SSIM", "PSNR"}:  # SSIM/PSNR pair them with other loader epochs
        assert evaluated[key] == final[key], key


def test_use_pallas_maps_to_use_kernels_and_defaults_to_true(tmp_path, monkeypatch):
    seen = []
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("nfdpm_tpu_torch.training.nf_trainer.train",
                        lambda **kw: seen.append(kw["cfg"]) or {"results": {}})
    run_baseline.main(["device=cpu", *SMALL])
    run_baseline.main(["device=cpu", *SMALL, "model.architecture.use_pallas=false"])
    run_baseline.main(["device=cpu", *SMALL, "model.architecture.use_pallas=true",
                       "model.architecture.remat=true"])
    assert [c.use_kernels for c in seen] == [True, False, True]
    assert [c.remat for c in seen] == [False, False, True]
    assert seen[0].levels == 2 and seen[0].steps == 1 and seen[0].coupling_width == 16


# ---------------------------------------------------------------------------
# The port's copies of the data pipeline and the config system
# ---------------------------------------------------------------------------

def test_synthetic_maker_matches_the_jax_package():
    a, b = tdata.synthetic(24, 8, 3, seed=5), jdata.synthetic(24, 8, 3, seed=5)
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.labels, b.labels)
    grey = tdata.synthetic(4, 8, 1, seed=1)
    np.testing.assert_array_equal(grey.images, jdata.synthetic(4, 8, 1, seed=1).images)


@pytest.mark.parametrize("hflip", [False, True])
def test_loader_epochs_match_the_jax_package(hflip):
    kw = dict(batch_size=8, img_size=8, seed=3, synthetic_n=40,
              transformations=["RandomHorizontalFlip"] if hflip else [])
    tl, jl = tpipe.read_dataset("synthetic", "", **kw), jpipe.read_dataset("synthetic", "", **kw)
    for name in ("train", "test", "eval"):
        a, b = getattr(tl, name), getattr(jl, name)
        assert len(a) == len(b) and a.num_samples == b.num_samples
    for epoch, start in ((0, 0), (3, 0), (3, 2)):
        ours = list(tl.train.iter_epoch(epoch, start))
        theirs = list(jl.train.iter_epoch(epoch, start))
        assert len(ours) == len(theirs) == 5 - start
        for (xa, la), (xb, lb) in zip(ours, theirs):
            # the JAX package's native gather multiplies by 1/255 where numpy
            # divides by 255: one ulp of a value below 1
            np.testing.assert_allclose(xa, xb, rtol=0, atol=6e-8)
            np.testing.assert_array_equal(la, lb)
    ours, theirs = list(tl.test.padded_batches()), list(jl.test.padded_batches())
    assert [n for _, _, n in ours] == [n for _, _, n in theirs] == [8, 2]
    np.testing.assert_allclose(ours[-1][0], theirs[-1][0], rtol=0, atol=6e-8)
    assert not ours[-1][0][2:].any()


def test_read_dataset_falls_back_only_when_asked(tmp_path):
    with pytest.raises(FileNotFoundError):
        tpipe.read_dataset("cifar10", str(tmp_path), batch_size=8)
    loaders = tpipe.read_dataset("MNIST", str(tmp_path), batch_size=8, img_size=8,
                                 synthetic_fallback=True, synthetic_n=16)
    assert loaders.train.dataset.images.shape == (16, 8, 8, 1)
    with pytest.raises(ValueError, match="Unknown dataset"):
        tpipe.read_dataset("nope", str(tmp_path), synthetic_fallback=True)


def test_config_copy_matches_the_jax_package(tmp_path, monkeypatch):
    from nfdpm_tpu.utils import config as jconfig

    overrides = ["model.optimizer.lr=1e-4", "data.digits=[1,2]", "+extra.key=true",
                 "experiment_name=copy", "load.load_exp_dir=null"]
    ours = tconfig.load_config(run_baseline.CONFIG, overrides)
    theirs = jconfig.load_config(str(REPO / "configs" / "nf_base.yaml"), overrides)
    assert dict(ours) == dict(theirs)
    assert ours.model.optimizer.lr == 1e-4 and ours.select("extra.key") is True
    assert ours.select("no.such.key", 7) == 7
    assert tconfig.parse_metric({"mode": ["clean"], "model_name": ["inception_v3"]}) == [
        {"mode": "clean", "model_name": "inception_v3"}]
    monkeypatch.chdir(tmp_path)
    first, second = tconfig.make_run_dir(ours), tconfig.make_run_dir(ours)
    assert first != second and Path(first, "checkpoints").is_dir()
    assert Path(second, "config.yaml").read_text() == ours.to_yaml()
    with pytest.raises(ValueError):
        tconfig.load_config(run_baseline.CONFIG, ["novalue"])
    assert tenv.parse_train_eval_mode("train") and not tenv.parse_train_eval_mode("eval")
