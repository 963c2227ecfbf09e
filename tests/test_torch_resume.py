"""Resume of nfdpm_tpu_torch's trainers, bit for bit on the CPU: the
counterparts of tests/test_resume.py.

  1. Epoch-level resume reproduces the uninterrupted run's parameters, Adam
     moments and step exactly.
  2. A KeyboardInterrupt in the middle of an epoch writes an emergency
     checkpoint and checkpoints/mid_epoch.json; resuming with the recorded
     (epoch, batch) reproduces the uninterrupted run exactly, and the run
     that completes removes the marker. The same for the stage-2 trainer
     (frozen flow, EMA every second step).
  3. The port writes the same marker as the JAX package for the same
     interrupt (the same loader proxy raising before batch 3).
  4. An interrupt that arrives inside a train step (the port updates its
     parameters in place) is held until the step has returned: the
     checkpoint holds whole steps and the marker counts them.

Glow L2/K1, coupling width 16, 8x8x3, batch 8, 48 synthetic images with
random horizontal flips (6 batches an epoch).
"""

import _thread
import logging

import numpy as np
import pytest
import torch

from _torch_port import interrupt_train_loader, one_torch_thread
from nfdpm_tpu.data import pipeline as jpipe
from nfdpm_tpu.models import glow as jglow
from nfdpm_tpu.training import checkpoint as jckpt
from nfdpm_tpu.training import nf_trainer as jnft
from nfdpm_tpu_torch import convert
from nfdpm_tpu_torch.data.pipeline import read_dataset
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.models.diffusion_prior import DiffusionPrior
from nfdpm_tpu_torch.models.formaters import IdentityFormater
from nfdpm_tpu_torch.models.nf_backbone import NFBackbone
from nfdpm_tpu_torch.training import checkpoint as tckpt
from nfdpm_tpu_torch.training import diffusion_trainer as tdt
from nfdpm_tpu_torch.training import nf_trainer as tnft


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


GLOW = dict(in_channels=3, levels=2, steps=1, coupling_width=16)
CFG = tglow.GlowConfig(**GLOW)
TCFG = tnft.NFTrainConfig(epochs=2, lr=1e-3, print_freq=100, save_checkpoint_freq=50)
LOGGER = logging.getLogger("test_torch_resume")
DATA = dict(batch_size=8, img_size=8, synthetic_fallback=True, synthetic_n=48,
            transformations=["RandomHorizontalFlip"])


def _loaders(interrupt_after=None):
    """Fresh loaders for each run (construction is deterministic); with
    `interrupt_after=n` the train loader raises KeyboardInterrupt before
    batch n of an epoch."""
    loaders = read_dataset("synthetic", "", **DATA)
    return loaders if interrupt_after is None else interrupt_train_loader(loaders,
                                                                          interrupt_after)


def _states_equal(a, b, keys=("params", "opt_state")):
    assert a["step"] == b["step"]
    for key in keys:
        la, lb = dict(convert.named_leaves(a[key])), dict(convert.named_leaves(b[key]))
        assert la.keys() == lb.keys()
        for name in la:
            if isinstance(la[name], torch.Tensor):
                assert torch.equal(la[name].detach(), lb[name].detach()), f"{key}/{name}"
            else:
                assert la[name] == lb[name], f"{key}/{name}"


def _train(run_dir, tcfg=TCFG, loaders=None, **kw):
    run_dir.mkdir(exist_ok=True)
    return tnft.train(cfg=CFG, tcfg=tcfg, loaders=loaders or _loaders(), run_dir=str(run_dir),
                      logger=LOGGER, img_size=8, device="cpu", **kw)


def test_epoch_level_resume_bit_exact(tmp_path):
    full = _train(tmp_path / "uninterrupted")
    one = tnft.NFTrainConfig(**{**TCFG.__dict__, "epochs": 1})
    _train(tmp_path / "split", one)
    resumed = _train(tmp_path / "split", one, resume_dir=str(tmp_path / "split"),
                     resume_epoch=1)
    _states_equal(full["state"], resumed["state"])
    assert resumed["state"]["step"] == 12 and resumed["results"] == full["results"]


def test_mid_epoch_resume_bit_exact(tmp_path):
    one = tnft.NFTrainConfig(**{**TCFG.__dict__, "epochs": 1})
    full = _train(tmp_path / "uninterrupted", one)
    run_b = tmp_path / "interrupted"
    with pytest.raises(KeyboardInterrupt):
        _train(run_b, one, _loaders(interrupt_after=3))
    marker = tckpt.load_mid_epoch_marker(str(run_b))
    assert marker == {"prefix": "gaussian", "epoch": 1, "batch_in_epoch": 3}
    emergency = tckpt.restore_state(str(run_b), "gaussian", 1, "cpu")
    assert emergency["step"] == 3 and emergency["opt_state"]["count"] == 3
    resumed = _train(run_b, one, resume_dir=str(run_b), resume_epoch=marker["epoch"],
                     resume_batch=marker["batch_in_epoch"])
    _states_equal(full["state"], resumed["state"])
    assert resumed["results"] == full["results"]
    assert tckpt.load_mid_epoch_marker(str(run_b)) is None  # the run completed


def test_mid_epoch_resume_diffusion(tmp_path):
    """The same guarantee for the stage-2 trainer (frozen flow, EMA every
    second step): UNets, Adam moments, EMA shadow and step."""
    backbone = NFBackbone(cfg=CFG, img_size=8, frozen=True)
    flow = tglow.init_glow(0, CFG, "cpu")
    dcfg = tdt.DiffusionTrainConfig(epochs=1, lr_diffusion=1e-3, print_freq=100,
                                    save_checkpoint_freq=50, ema_decay=0.9,
                                    ema_update_every=2)

    def run(run_dir, loaders, **kw):
        run_dir.mkdir(exist_ok=True)
        dp = DiffusionPrior(formater=IdentityFormater(L=2, in_channels=3, size=8),
                            unet_kwargs={"dim": 8, "dim_mults": (1,),
                                         "resnet_block_groups": 2},
                            diffusion_kwargs={"timesteps": 4, "loss_type": "l2"})
        return tdt.train(backbone=backbone, flow_params=flow, dp=dp, tcfg=dcfg,
                         loaders=loaders, run_dir=str(run_dir), logger=LOGGER,
                         device="cpu", **kw)

    full = run(tmp_path / "uninterrupted", _loaders())
    run_b = tmp_path / "interrupted"
    with pytest.raises(KeyboardInterrupt):
        run(run_b, _loaders(interrupt_after=3))
    marker = tckpt.load_mid_epoch_marker(str(run_b))
    assert marker == {"prefix": "diffusion", "epoch": 1, "batch_in_epoch": 3}
    assert "ema" in tckpt.checkpoint_keys(str(run_b), "diffusion", 1)
    resumed = run(run_b, _loaders(), resume_dir=str(run_b), resume_epoch=1, resume_batch=3)
    _states_equal(full["state"], resumed["state"], ("params", "opt_state", "ema"))
    assert tckpt.load_mid_epoch_marker(str(run_b)) is None


def test_marker_equals_the_jax_packages_for_the_same_interrupt(tmp_path):
    jloaders = interrupt_train_loader(jpipe.read_dataset("synthetic", root="", **DATA), 3)
    (tmp_path / "jax").mkdir()
    with pytest.raises(KeyboardInterrupt):
        jnft.train(cfg=jglow.GlowConfig(**GLOW), tcfg=jnft.NFTrainConfig(
            epochs=1, lr=1e-3, print_freq=100, save_checkpoint_freq=50),
            loaders=jloaders, run_dir=str(tmp_path / "jax"), logger=LOGGER, img_size=8)
    with pytest.raises(KeyboardInterrupt):
        _train(tmp_path / "port", tnft.NFTrainConfig(**{**TCFG.__dict__, "epochs": 1}),
               _loaders(interrupt_after=3))
    want = jckpt.load_mid_epoch_marker(str(tmp_path / "jax"))
    assert want == {"prefix": "gaussian", "epoch": 1, "batch_in_epoch": 3}
    assert tckpt.load_mid_epoch_marker(str(tmp_path / "port")) == want


def test_interrupt_inside_a_step_waits_for_the_step(tmp_path, monkeypatch):
    """SIGINT delivered while step 2 runs (as the watchdog's interrupt_main
    would be) is raised once the step has returned: the emergency checkpoint
    is at step 2 and resumes to the uninterrupted run's state."""
    one = tnft.NFTrainConfig(**{**TCFG.__dict__, "epochs": 1})
    full = _train(tmp_path / "uninterrupted", one)
    make = tnft.make_train_step

    def make_interrupted(*args, **kw):
        step = make(*args, **kw)

        def train_step(state, batch, seed):
            if state["step"] == 1:
                _thread.interrupt_main()  # arrives inside this step
                for _ in range(1000):     # bytecode boundaries where it would land
                    pass
            return step(state, batch, seed)

        return train_step

    monkeypatch.setattr(tnft, "make_train_step", make_interrupted)
    run_b = tmp_path / "interrupted"
    with pytest.raises(KeyboardInterrupt):
        _train(run_b, one)
    monkeypatch.setattr(tnft, "make_train_step", make)
    assert tckpt.load_mid_epoch_marker(str(run_b)) == {
        "prefix": "gaussian", "epoch": 1, "batch_in_epoch": 2}
    state = tckpt.restore_state(str(run_b), "gaussian", 1, "cpu")
    assert state["step"] == 2 and state["opt_state"]["count"] == 2
    resumed = _train(run_b, one, resume_dir=str(run_b), resume_epoch=1, resume_batch=2)
    _states_equal(full["state"], resumed["state"])


def test_prefetch_hands_out_the_fetched_batch_before_the_interrupt():
    from nfdpm_tpu_torch.data.pipeline import prefetch_to_device

    def batches():
        for i in range(3):
            yield np.full((1, 2), i, np.float32), np.zeros(1)
        raise KeyboardInterrupt

    got = []
    with pytest.raises(KeyboardInterrupt):
        for imgs, _ in prefetch_to_device(batches(), torch.device("cpu")):
            got.append(int(imgs[0, 0]))
    assert got == [0, 1, 2]
