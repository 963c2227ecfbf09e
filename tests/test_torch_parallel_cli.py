"""The port's entry points and tools under data parallelism, on the CPU.

  * `torchrun --standalone --nproc-per-node=2 -m nfdpm_tpu_torch.run_baseline
    device=cpu parallel.fsdp=true` (gloo named by NFDPM_DIST_BACKEND), the
    README's command: one run directory, written by rank 0, and the final
    bits/dim of the same run in one process within 1e-5.
  * Both entry points as two gloo ranks (tests/_torch_parallel_worker.py):
    stage 1 and stage 2 with `parallel.fsdp=true` (stage 2 with latent
    standardization: the stats of each rank's rows, summed, within 1e-5 of
    one process's) and stage 2 with
    `parallel.part_parallel=true` (two parts, one a rank), each against the
    same run in one process: bits/dim within 1e-5, the VLB (a bound of
    about 38 bits/dim at this size, float32 sums) within 1e-5 relative; the
    part-parallel run's merged checkpoint read by `phase=eval` (the same
    VLB) and by runload (`serve --run-dir`'s reader).
  * What stays refused, by both entry points: the model axis.
  * `serve --data-parallel --device cpu`: the same bytes as without the
    flag, and "devices": 1.
Glow L2/K1/w16 at 8x8x3, batch 8, UNets of dim 8.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_port import one_torch_thread, run_ranks
from nfdpm_tpu_torch import run_baseline, run_diffusion_prior, serve
from nfdpm_tpu_torch.training import checkpoint as tckpt
from nfdpm_tpu_torch.training import runload

REPO = Path(__file__).resolve().parents[1]
SMALL = ["data.name=synthetic", "data.synthetic_fallback=true", "data.batch_size=8",
         "data.img_size=8", "data.synthetic_n=64", "model.architecture.L=2",
         "model.architecture.K=1", "model.architecture.coupling_width=16",
         "model.training.epochs=1", "model.training.save_checkpoint_freq=1",
         "model.training.print_freq=4"]
STAGE2 = ["device=cpu", "data.name=synthetic", "data.synthetic_fallback=true",
          "data.batch_size=8", "data.img_size=8", "data.synthetic_n=32",
          "model.normalizing_flow.init_nf.pretrain.dir={stage1}",
          "model.normalizing_flow.init_nf.pretrain.epoch=1", "model.unet.dim=8",
          "model.unet.dim_mults=[1,2]", "model.unet.resnet_block_groups=2",
          "model.diffusion.timesteps=8", "model.diffusion.sampling_timesteps=4",
          "model.training.epochs=1", "model.training.print_freq=2",
          "model.training.save_checkpoint_freq=1", "model.evaluation.vlb_batches=1"]
RUNS = {"fsdp": ["experiment_name=s2_fsdp", "parallel.fsdp=true",
                 "model.normalizing_flow.standardize_latents=true",
                 "model.normalizing_flow.standardize_batches=3"],
        "part_parallel": ["experiment_name=s2_pp", "parallel.part_parallel=true"]}
BPD_TOL, VLB_RTOL = 1e-5, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both entry points as two gloo ranks, then the same runs in this
    process (one rank, no launch)."""
    d = tmp_path_factory.mktemp("cli")
    job = {"scenarios": ["entry"], "entry": {
        "stage1": ["device=cpu", *SMALL, "experiment_name=s1", "parallel.fsdp=true"],
        "stage2": {name: STAGE2 + extra for name, extra in RUNS.items()}}}
    out = run_ranks(job, 2, d)
    one = d / "one_rank"
    one.mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(one)
        mp.setenv("NFDPM_NO_TENSORBOARD", "1")
        s1 = run_baseline.main(["device=cpu", *SMALL, "experiment_name=s1"])
        stage1 = Path(s1["run_dir"]).name
        s2 = {name: run_diffusion_prior.main(
                  [a.replace("{stage1}", stage1) for a in STAGE2 + extra])
              for name, extra in RUNS.items()}
    return dict(d=d, out=out, one=one, s1=s1, s2=s2, stage1=stage1)


def test_entry_points_as_two_ranks_match_one_rank(ranks):
    r0, r1 = (o["entry"] for o in ranks["out"])
    for key in r0:  # both ranks report the same numbers and the same run directory
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
    s1 = ranks["s1"]["results"]
    np.testing.assert_allclose(r0["stage1/bpd"], [s1["bpd_test"], s1["bpd_train"]],
                               rtol=0, atol=BPD_TOL)
    for name in RUNS:
        want = ranks["s2"][name]["vlb_bpd"]
        assert abs(float(r0[f"{name}/vlb"]) - want) <= VLB_RTOL * abs(want), name
    # the latent stats of the fsdp run: each rank's rows of 3 batches, summed
    import json

    stats = [json.loads((root / "outputs" / str(run) / "diffusion_architecture.json")
                        .read_text())["formater_stats"]
             for root, run in ((ranks["d"], r0["fsdp/run_dir"]),
                               (ranks["one"], Path(ranks["s2"]["fsdp"]["run_dir"]).name))]
    assert stats[0] is not None
    np.testing.assert_allclose(np.concatenate([np.ravel(x) for part in stats[0] for x in part]),
                               np.concatenate([np.ravel(x) for part in stats[1] for x in part]),
                               rtol=1e-5, atol=1e-6)
    # rank 0 wrote the run directories, rank 1 only its log
    s1_dir = ranks["d"] / "outputs" / str(r0["stage1/run_dir"])
    assert (s1_dir / "architecture.json").exists()
    assert (s1_dir / "checkpoints" / "model_gaussian_001.pt").exists()
    assert (s1_dir / "train.log").exists() and (s1_dir / "train_rank1.log").exists()
    assert len(list((ranks["d"] / "outputs").iterdir())) == 3


def test_part_parallel_run_is_read_as_a_joint_run(ranks, monkeypatch):
    """Its merged checkpoint: phase=eval gives the VLB the run reported, and
    runload (what `serve --run-dir` reads) rebuilds the prior."""
    r0 = ranks["out"][0]["entry"]
    run = ranks["d"] / "outputs" / str(r0["part_parallel/run_dir"])
    assert (run / "checkpoints" / "model_diffusion_parts_001.pt").exists()
    assert (run / "checkpoints" / "model_diffusion_001.pt").exists()
    monkeypatch.chdir(ranks["d"])
    evaluated = run_diffusion_prior.main(
        [a.replace("{stage1}", str(r0["stage1/run_dir"])) for a in STAGE2]
        + ["experiment_name=pp_eval", "phase=eval", f"load.load_exp_dir={run.name}",
           "load.load_epoch=1"])
    want = float(r0["part_parallel/vlb"])
    assert abs(evaluated["vlb_bpd"] - want) <= VLB_RTOL * abs(want)
    kind, loaded = runload.load_run(str(run), None, None, True, None, "cpu")
    assert kind == "diffusion" and loaded.epoch == 1
    assert len(loaded.params["diffusion"]["parts"]) == 2
    assert set(tckpt.checkpoint_keys(str(run), "diffusion", 1)) == {"params", "step"}


def test_torchrun_runs_the_readme_command(tmp_path, ranks):
    env = {"PYTHONPATH": str(REPO), "PATH": os.environ["PATH"], "NFDPM_NO_TENSORBOARD": "1",
           "OMP_NUM_THREADS": "1", "NFDPM_DIST_BACKEND": "gloo"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2",
           "-m", "nfdpm_tpu_torch.run_baseline", "device=cpu", *SMALL,
           "experiment_name=s1", "parallel.fsdp=true"]
    try:
        out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=120,
                             env=env)
    except subprocess.TimeoutExpired as e:  # the ranks die with the launcher
        pytest.fail(f"torchrun timed out: {e.stdout}")
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    (run,) = (tmp_path / "outputs").iterdir()
    log = (run / "train.log").read_text()
    s1 = ranks["s1"]["results"]
    for split in ("test", "train"):
        value = float(log.split(f"final {split} bpd: ")[1].split()[0])
        assert abs(value - s1[f"bpd_{split}"]) <= 5e-5  # the log's four decimals
    assert "Data parallel: Mesh(data=2" in log


@pytest.mark.parametrize("override", ["parallel.n_model=2", "parallel.spatial=true"])
@pytest.mark.parametrize("entry", [run_baseline, run_diffusion_prior])
def test_the_model_axis_stays_refused(tmp_path, monkeypatch, entry, override):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="tensor, pipeline and spatial"):
        entry.main(["device=cpu", override])
    assert not (tmp_path / "outputs").exists()


def test_serve_data_parallel_gives_the_same_bytes(ranks):
    run = ranks["one"] / "outputs" / ranks["stage1"]
    samples, infos = [], []
    for flag in ([], ["--data-parallel"]):
        args = serve.parse_args(["--run-dir", str(run), "--device", "cpu", "--batch", "8",
                                 *flag])
        sample_images, info = serve.build_sampler(args)
        samples.append(sample_images(12, 1.0, 7))
        infos.append(info)
    np.testing.assert_array_equal(samples[0], samples[1])
    assert infos[0]["devices"] == infos[1]["devices"] == 1
