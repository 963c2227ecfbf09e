"""Stage-1 training of nfdpm_tpu_torch against nfdpm_tpu on the CPU.

The optimizer against optax's chain on random gradient trees; a 5-step Adam
trajectory against the JAX train step from the same converted state and the
same injected dequantization noise (bits/dim per step within 1e-3, the
repository's gate for trained trajectories; the measured gap is about 1e-6);
gradient accumulation, the fixed prior, the IWAE bound, checkpoints and
epoch-level resume. Glow L2/K2, coupling width 32, 8x8x3, batch 8. The JAX
flow runs its Pallas route in interpret mode, the port its kernel route (the
autograd Functions over the kernels' plain versions on CPU tensors).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import adam_moments, one_torch_thread, randomize, t, to_numpy_tree
from nfdpm_tpu.models import glow as jglow
from nfdpm_tpu.models import prior as jprior
from nfdpm_tpu.training import nf_trainer as jnft
from nfdpm_tpu.training import optim as joptim
from nfdpm_tpu_torch import convert
from nfdpm_tpu_torch.data import pipeline as tpipe
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.training import checkpoint as tckpt
from nfdpm_tpu_torch.training import nf_trainer as tnft
from nfdpm_tpu_torch.training import optim as toptim
from nfdpm_tpu_torch.training import tracking as ttrack

IMG, BATCH = 8, 8
GLOW = dict(in_channels=3, levels=2, steps=2, coupling_width=32, learn_prior=True)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _leaves(tree):
    """{path: tensor} of a tree's tensor leaves (an optimizer state's count
    is an int and left out)."""
    return {k: v for k, v in convert.named_leaves(tree) if isinstance(v, torch.Tensor)}


def _tree(seed=0):
    """A small {"flow", "prior"} tree in the JAX layout with random leaves."""
    jcfg = jglow.GlowConfig(**GLOW)
    flow = jglow.init_glow(seed, jcfg)
    prior = jprior.init_gaussian_prior(tglow.final_channels(tglow.GlowConfig(**GLOW)), True)
    return randomize(to_numpy_tree({"flow": flow, "prior": prior}), seed=seed + 1)


# ---------------------------------------------------------------------------
# Optimizer against optax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["adam", "adamw"])
@pytest.mark.parametrize("fixed_prior", [True, False])
@pytest.mark.parametrize("grad_scale", [1e-3, 0.05, 3.0],
                         ids=["norm<1", "norm>1", "values>1"])
def test_optimizer_matches_optax(name, fixed_prior, grad_scale):
    tree = _tree()
    rng = np.random.default_rng(7)
    # p_mat and sign are constants of the loss (the JAX flow stops their
    # gradient), and optax.masked hands a masked leaf's gradient through as
    # its update: a true gradient tree has zeros there
    grads = jax.tree_util.tree_map_with_path(
        lambda p, a: ((0.0 if joptim._is_frozen_path(p) else grad_scale)
                      * rng.standard_normal(a.shape)).astype(np.float32), tree)
    jtx = joptim.make_optimizer(name, 1e-2, fixed_prior=fixed_prior)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jtx.init(jparams)
    ttx = toptim.make_optimizer(name, 1e-2, fixed_prior=fixed_prior)
    tparams = convert.trainable(convert.from_jax_params(tree, "cpu"))
    tgrads = convert.from_jax_params(grads, "cpu")
    tstate = ttx.init(tparams)

    flat = np.concatenate([g.ravel() for p, g in jax.tree_util.tree_flatten_with_path(grads)[0]
                           if not joptim._is_frozen_path(p)
                           and not (fixed_prior and p[0].key == "prior")])
    norm = np.linalg.norm(np.clip(flat, -1, 1))
    assert (norm < 1) == (grad_scale == 1e-3)  # the cases lie on both sides of the clip

    for _ in range(3):
        updates, jstate = jtx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tstate = ttx.apply(tparams, tgrads, tstate)
    want = _leaves(convert.from_jax_params(to_numpy_tree(jparams), "cpu"))
    start = _leaves(convert.from_jax_params(tree, "cpu"))
    for path, leaf in convert.named_leaves(tparams):
        # three updates of up to lr = 1e-2 each: 1e-4 of that movement
        np.testing.assert_allclose(leaf.detach().numpy(), want[path].numpy(), rtol=0,
                                   atol=3e-6, err_msg=path)
        moved = not torch.equal(leaf.detach(), start[path])
        assert moved == ttx.updates(path), path
    assert not ttx.updates("flow/blocks/0/steps/0/invconv/p_mat")
    assert ttx.updates("prior/bias") == (not fixed_prior)
    mu, nu, count = adam_moments(jstate, tree)
    assert tstate["count"] == count == 3
    for got, expected in ((tstate["mu"], mu), (tstate["nu"], nu)):
        want = _leaves(convert.from_jax_params(expected, "cpu"))
        for path, leaf in convert.named_leaves(got):
            np.testing.assert_allclose(leaf.numpy(), want[path].numpy(), rtol=1e-4,
                                       atol=1e-12, err_msg=path)


def test_fixed_prior_stays_out_of_the_global_norm():
    """A huge prior gradient would scale every flow gradient down if it
    entered the norm."""
    params = {"flow": {"w": torch.ones(4, requires_grad=True)},
              "prior": {"bias": torch.ones(2, requires_grad=True)}}
    grads = {"flow": {"w": torch.full((4,), 0.1)}, "prior": {"bias": torch.full((2,), 1e3)}}
    fixed = toptim.make_optimizer("adam", 1e-3, fixed_prior=True)
    clipped = fixed.clipped([grads["flow"]["w"]])
    assert torch.equal(clipped[0], grads["flow"]["w"])
    state = fixed.apply(params, grads, fixed.init(params))
    assert torch.equal(params["prior"]["bias"].detach(), torch.ones(2))
    assert torch.equal(state["mu"]["prior"]["bias"], torch.zeros(2))
    np.testing.assert_allclose(state["mu"]["flow"]["w"].numpy(), 0.01, rtol=1e-6)
    # trained prior: value clip to 1, then norm sqrt(2 + 0.04) > 1 scales all
    free = toptim.make_optimizer("adam", 1e-3, fixed_prior=False)
    state = free.apply(params, grads, free.init(params))
    np.testing.assert_allclose(state["mu"]["flow"]["w"].numpy(),
                               0.1 * 0.1 / np.sqrt(2.04), rtol=1e-5)
    with pytest.raises(ValueError, match="no gradient"):
        free.apply(params, {"flow": {"w": None}, "prior": grads["prior"]}, free.init(params))


@pytest.mark.parametrize("kind,kw", [
    ("constant", dict()),
    ("constant", dict(warmup_steps=10)),
    ("cosine", dict(warmup_steps=10, decay_steps=100, end_lr_factor=0.1)),
    ("cosine", dict(warmup_steps=0, decay_steps=50, end_lr_factor=0.0)),
])
def test_lr_schedules_match_optax(kind, kw):
    jsched = joptim.make_lr_schedule(1e-3, kind, **kw)
    tsched = toptim.make_lr_schedule(1e-3, kind, **kw)
    end = kw.get("decay_steps", 40)
    for step in (0, 1, 5, kw.get("warmup_steps", 0), kw.get("warmup_steps", 0) + 1,
                 end // 2, end - 1, end, end + 25):
        want = float(jsched(step)) if callable(jsched) else jsched
        assert tsched(step) == pytest.approx(want, rel=1e-5, abs=1e-10), step
    if kw.get("warmup_steps"):
        assert tsched(0) == 0.0  # the first update of a warmed-up run is zero
    with pytest.raises(ValueError):
        toptim.make_lr_schedule(1e-3, "cosine")
    with pytest.raises(ValueError):
        toptim.make_lr_schedule(1e-3, "linear")


def test_warmup_first_update_is_zero_and_the_count_rides_in_the_state():
    tx = toptim.make_optimizer("adam", 1e-3, lr_schedule=toptim.make_lr_schedule(
        1e-3, "constant", warmup_steps=5))
    params = {"flow": {"w": torch.ones(3, requires_grad=True)}, "prior": {}}
    grads = {"flow": {"w": torch.ones(3)}, "prior": {}}
    state = tx.apply(params, grads, tx.init(params))
    assert torch.equal(params["flow"]["w"].detach(), torch.ones(3))
    state = tx.apply(params, grads, state)
    assert state["count"] == 2 and params["flow"]["w"].max() < 1.0
    with pytest.raises(ValueError):
        toptim.make_optimizer("sgd")


# ---------------------------------------------------------------------------
# Trajectory against the JAX train step
# ---------------------------------------------------------------------------

def _batches(n, seed=11):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, BATCH, IMG, IMG, 3)).astype(np.float32) / 255.0
    return imgs, rng.random(imgs.shape).astype(np.float32)


@pytest.fixture(scope="module")
def jax_trajectory():
    """Five steps of the JAX train step (one jit compile) from a ddinit'ed
    state: the start tree, the per-step bits/dim, the Adam moments after
    step 1 and the final parameters."""
    jcfg = jglow.GlowConfig(use_pallas=True, **GLOW)
    jtcfg = jnft.NFTrainConfig(lr=1e-3)
    tx = joptim.make_optimizer("adam", 1e-3, fixed_prior=True)
    tree = _tree(seed=3)
    imgs, noise = _batches(5)
    x0 = imgs[0] - 0.5 + noise[0] / 32
    tree["flow"] = to_numpy_tree(jglow.ddinit(jax.tree.map(jnp.asarray, tree["flow"]), jcfg,
                                              jnp.asarray(x0)))
    params = jax.tree.map(jnp.asarray, tree)
    state = {"params": params, "opt_state": tx.init(params), "step": jnp.zeros((), jnp.int32)}
    step = jnft.make_train_step(jcfg, jtcfg, tx, inject_noise=True)
    bpds, moments = [], None
    for i in range(5):
        state, metrics = step(state, jnp.asarray(imgs[i]), jnp.asarray(noise[i]))
        bpds.append(float(metrics["bpd"]))
        if i == 0:
            moments = adam_moments(state["opt_state"], tree)
    return tree, imgs, noise, bpds, moments, to_numpy_tree(state["params"])


def test_five_step_adam_trajectory_matches_jax(jax_trajectory):
    tree, imgs, noise, bpds_j, (mu_j, nu_j, count_j), final_j = jax_trajectory
    cfg = tglow.GlowConfig(use_kernels=True, **GLOW)
    tcfg = tnft.NFTrainConfig(lr=1e-3)
    tx = tnft.optimizer_of(tcfg)
    params = convert.trainable(convert.from_jax_params(tree, "cpu"))
    state = {"params": params, "opt_state": tx.init(params), "step": 0}
    step = tnft.make_train_step(cfg, tcfg, tx, inject_noise=True, device="cpu")
    gaps = []
    for i in range(5):
        state, metrics = step(state, imgs[i], noise[i])
        assert metrics["bpd"].dim() == 0 and not metrics["bpd"].requires_grad
        gaps.append(abs(float(metrics["bpd"]) - bpds_j[i]))
        if i == 0:
            mu, nu, count = convert.opt_state_to_jax(state["opt_state"])
            assert count == count_j == 1
            for got, want in ((mu, mu_j), (nu, nu_j)):
                for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-9)
    assert max(gaps) < 1e-3, gaps  # the gate; measured about 1e-6
    assert max(gaps) < 5e-5, gaps
    assert state["step"] == 5 and state["opt_state"]["count"] == 5
    assert bpds_j[-1] < bpds_j[0]
    for a, b in zip(jax.tree.leaves(convert.to_jax_params(state["params"])),
                    jax.tree.leaves(final_j)):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-4)  # 5 updates of 1e-3 each
    # fixed prior (the default): its leaves never move
    for name in ("bias", "logs"):
        np.testing.assert_array_equal(state["params"]["prior"][name].detach().numpy(),
                                      tree["prior"][name])


def test_opt_state_crosses_the_bridge_both_ways(jax_trajectory):
    tree, _, _, _, (mu_j, nu_j, count_j), _ = jax_trajectory
    state = convert.opt_state_from_jax(mu_j, nu_j, count_j, "cpu")
    assert state["count"] == 1
    assert _leaves(state["mu"]).keys() == _leaves(convert.from_jax_params(tree, "cpu")).keys()
    mu, nu, count = convert.opt_state_to_jax(state)
    for a, b in zip(jax.tree.leaves((mu, nu)), jax.tree.leaves((mu_j, nu_j))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The train step's own properties
# ---------------------------------------------------------------------------

def _state(cfg, tcfg, seed=0):
    tx = tnft.optimizer_of(tcfg)
    params = convert.trainable(convert.from_jax_params(_tree(seed), "cpu"))
    return tx, {"params": params, "opt_state": tx.init(params), "step": 0}


def test_grad_accum_two_equals_the_manual_average():
    cfg = tglow.GlowConfig(**GLOW)
    tcfg = tnft.NFTrainConfig(grad_accum=2)
    tx, state = _state(cfg, tcfg)
    imgs, _ = _batches(1)
    # the manual average, from the same per-microbatch generators
    manual = convert.trainable(convert.from_jax_params(_tree(0), "cpu"))
    loss_fn = tnft.make_loss_fn(cfg, tcfg)
    gen = torch.Generator()
    sums, bpds = None, []
    for i, micro in enumerate(t(imgs[0]).chunk(2)):
        bpd, _ = loss_fn(manual, micro, tnft.inference.reseed(gen, tnft._STEP, 5, 0, i))
        leaves = [p for _, p in convert.named_leaves(manual) if p.requires_grad]
        grads = torch.autograd.grad(bpd, leaves)
        sums = grads if sums is None else [a + b for a, b in zip(sums, grads)]
        bpds.append(float(bpd.detach()))
    step = tnft.make_train_step(cfg, tcfg, tx, device="cpu")
    state, metrics = step(state, imgs[0], 5)
    got = [p.grad for _, p in convert.named_leaves(state["params"]) if p.requires_grad]
    for a, b in zip(got, sums):
        assert torch.equal(a, b / 2)
    assert float(metrics["bpd"]) == pytest.approx(np.mean(bpds), rel=1e-6)
    with pytest.raises(ValueError, match="grad_accum"):
        tnft.make_train_step(cfg, tcfg, tx, inject_noise=True, device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        step(state, imgs[0][:7], 5)


def test_step_noise_is_a_pure_function_of_seed_and_step():
    cfg, tcfg = tglow.GlowConfig(**GLOW), tnft.NFTrainConfig()
    imgs, _ = _batches(1)
    runs = []
    for seed, start in ((5, 0), (5, 0), (6, 0), (5, 1)):
        tx, state = _state(cfg, tcfg)
        state["step"] = start
        step = tnft.make_train_step(cfg, tcfg, tx, device="cpu")
        runs.append(float(step(state, imgs[0], seed)[1]["bpd"]))
    assert runs[0] == runs[1] and runs[0] != runs[2] and runs[0] != runs[3]


@pytest.mark.parametrize("fixed", [True, False])
def test_fixed_prior_never_updates(fixed):
    cfg = tglow.GlowConfig(**GLOW)
    tcfg = tnft.NFTrainConfig(compat_fixed_prior=fixed)
    tx, state = _state(cfg, tcfg)
    before = {k: v.detach().clone() for k, v in state["params"]["prior"].items()}
    p_mat = state["params"]["flow"]["final_steps"][0]["invconv"]["p_mat"].clone()
    imgs, _ = _batches(2)
    step = tnft.make_train_step(cfg, tcfg, tx, device="cpu")
    for i in range(2):
        state, _ = step(state, imgs[i], 0)
    for k, v in state["params"]["prior"].items():
        assert torch.equal(v.detach(), before[k]) == fixed
    assert torch.equal(state["params"]["flow"]["final_steps"][0]["invconv"]["p_mat"], p_mat)


# ---------------------------------------------------------------------------
# Evaluation, checkpoints, the training loop
# ---------------------------------------------------------------------------

def _loaders(n=32):
    return tpipe.read_dataset("synthetic", "", batch_size=BATCH, img_size=IMG, seed=3,
                              synthetic_n=n)


def test_iwae_bound_is_at_most_the_mean_bound():
    cfg, tcfg = tglow.GlowConfig(**GLOW), tnft.NFTrainConfig()
    params = convert.from_jax_params(_tree(), "cpu")
    eval_step = tnft.make_eval_step(cfg, tcfg, "cpu")
    loader = _loaders().test  # 8 images... padded to one batch
    single = tnft.calculate_bpd(eval_step, params, loader, 1)
    again = tnft.calculate_bpd(eval_step, params, loader, 1)
    mean = tnft.calculate_bpd(eval_step, params, loader, 1, n_dequant_samples=4)
    iwae = tnft.calculate_bpd(eval_step, params, loader, 1, n_dequant_samples=4, iwae=True)
    assert single == again and np.isfinite(single)
    assert iwae <= mean + 1e-7 and iwae != mean
    assert abs(mean - single) < 0.5


def test_calculate_bpd_masks_the_padding():
    cfg, tcfg = tglow.GlowConfig(**GLOW), tnft.NFTrainConfig()
    params = convert.from_jax_params(_tree(), "cpu")
    eval_step = tnft.make_eval_step(cfg, tcfg, "cpu")
    ds = tpipe.synthetic(11, IMG, 3, seed=4)
    loader = tpipe.Loader(ds, BATCH)
    got = tnft.calculate_bpd(eval_step, params, loader, 2)
    per_image = []
    for i, (imgs, _, n_valid) in enumerate(loader.padded_batches()):
        gen = tnft.inference.reseed(torch.Generator(), tnft._EVAL, 2, i * 131)
        per_image += eval_step(params, imgs, gen)[:n_valid].tolist()
    assert len(per_image) == 11
    assert got == pytest.approx(np.mean(per_image), rel=1e-6)


def test_checkpoint_round_trip(tmp_path):
    cfg, tcfg = tglow.GlowConfig(**GLOW), tnft.NFTrainConfig()
    tx, state = _state(cfg, tcfg)
    imgs, _ = _batches(1)
    state, _ = tnft.make_train_step(cfg, tcfg, tx, device="cpu")(state, imgs[0], 0)
    run_dir = str(tmp_path)
    assert tckpt.latest_epoch(run_dir, "gaussian") is None
    path = tckpt.save_state(run_dir, "gaussian", 3, state)
    tckpt.save_state(run_dir, "gaussian", 12, state)
    assert path.endswith("checkpoints/model_gaussian_003.pt")
    assert tckpt.latest_epoch(run_dir, "gaussian") == 12
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == [
        "model_gaussian_003.pt", "model_gaussian_012.pt"]  # no temporary file left
    back = tckpt.restore_state(run_dir, "gaussian", 3, "cpu")
    assert back["step"] == 1 and back["opt_state"]["count"] == 1
    for key in ("params", "opt_state"):
        a, b = _leaves(state[key]), _leaves(back[key])
        assert a.keys() == b.keys()
        for name in a:
            assert torch.equal(a[name].detach(), b[name]), name
    for name, leaf in convert.named_leaves(back["params"]):
        assert leaf.is_leaf and leaf.requires_grad == (not convert.is_frozen_path(name))
    conv = back["params"]["flow"]["final_steps"][0]["coupling"]["net"]["conv1"]["w"]
    assert conv.is_contiguous(memory_format=torch.channels_last)
    params = tckpt.restore_params(run_dir, "gaussian", 3, "cpu")
    assert _leaves(params).keys() == _leaves(state["params"]).keys()
    assert not any(p.requires_grad for p in _leaves(params).values())
    tckpt.save_architecture(run_dir, {"L": 2, "K": 2})
    assert tckpt.load_architecture(run_dir) == {"L": 2, "K": 2}


def _train(tmp_path, name, epochs, **kw):
    cfg = tglow.GlowConfig(**GLOW)
    tcfg = tnft.NFTrainConfig(epochs=epochs, print_freq=2, save_checkpoint_freq=1)
    run_dir = tmp_path / name
    run_dir.mkdir()
    out = tnft.train(cfg=cfg, tcfg=tcfg, loaders=_loaders(), run_dir=str(run_dir),
                     logger=logging.getLogger("test_torch_train"), seed=9, img_size=IMG,
                     device="cpu", **kw)
    return run_dir, out


def test_epoch_level_resume_equals_the_uninterrupted_run(tmp_path):
    full_dir, full = _train(tmp_path, "full", 2)
    _, first = _train(tmp_path, "first", 1)
    resumed_dir, resumed = _train(tmp_path, "resumed", 1,
                                  resume_dir=str(tmp_path / "first"), resume_epoch=1)
    assert resumed["results"] == full["results"]
    assert first["results"] != full["results"]
    assert resumed["state"]["step"] == full["state"]["step"] == 8
    for key in ("params", "opt_state"):
        a, b = _leaves(full["state"][key]), _leaves(resumed["state"][key])
        for name in a:
            assert torch.equal(a[name].detach(), b[name].detach()), name
    assert tckpt.latest_epoch(str(resumed_dir), "gaussian") == 2

    # what a run directory holds
    arch = tckpt.load_architecture(str(full_dir))
    assert arch == {"L": 2, "K": 2, "in_channels": 3, "img_size": IMG, "coupling_width": 32,
                    "learn_prior": True, "n_bits": 5, "fixed_prior": True,
                    "temperature": 1.0, "optimizer": "adam", "invconv_param": "plu"}
    records = [__import__("json").loads(line) for line in
               (full_dir / "metrics.jsonl").read_text().splitlines()]
    train_bpd = [r["value"] for r in records if r["name"] == "bpd"
                 and r["context"] == {"subset": "train"}]
    assert len(train_bpd) == 4 and train_bpd[-1] < train_bpd[0]
    finals = {r["context"]["subset"]: r["value"] for r in records
              if r["context"].get("final")}
    assert finals == {"test": full["results"]["bpd_test"],
                      "train": full["results"]["bpd_train"]}
    grids = sorted(p.name for p in (full_dir / "results").iterdir())
    assert grids == ["checkpoint_samples_e1_s4.png", "checkpoint_samples_e2_s8.png"]
    assert (full_dir / "results" / grids[0]).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    # the trained parameters score as training logged, from the checkpoint alone
    params = tckpt.restore_params(str(full_dir), "gaussian", 2, "cpu")
    eval_step = tnft.make_eval_step(tglow.GlowConfig(**GLOW), tnft.NFTrainConfig(), "cpu")
    assert tnft.final_bpd(eval_step, params, _loaders(), 9) == full["results"]


def test_png_encoder_round_trips_through_an_image_reader(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(0)
    for channels in (3, 1):
        images = rng.integers(0, 256, (5, 6, 4, channels), dtype=np.uint8)
        grid = ttrack.save_image_grid(images, str(tmp_path / f"g{channels}.png"))
        assert grid.shape == (1 * 7 + 1, 5 * 5 + 1, channels)
        back = np.asarray(Image.open(tmp_path / f"g{channels}.png"))
        np.testing.assert_array_equal(back.reshape(grid.shape), grid)
    with pytest.raises(ValueError):
        ttrack.png_bytes(np.zeros((4, 4, 2), np.uint8))


def test_prefetch_to_device_keeps_order_and_values():
    loader = _loaders().train
    plain = list(loader.iter_epoch(0))
    ahead = list(tpipe.prefetch_to_device(loader.iter_epoch(0), torch.device("cpu")))
    assert len(ahead) == len(plain) == 4
    for (a, la), (b, lb) in zip(ahead, plain):
        assert isinstance(a, torch.Tensor) and a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(la, lb)
    assert list(tpipe.prefetch_to_device(iter(()), torch.device("cpu"))) == []
