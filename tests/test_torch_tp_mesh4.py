"""The model axis at four gloo ranks: a (data 2, model 2) mesh of
nfdpm_tpu_torch against nfdpm_tpu on the CPU.

One launch (tests/_torch_tp_scenarios.py: coords, tp_steps; the
part-parallel scenario of tests/_torch_parallel_worker.py):
  * each rank's data and model index and its groups' members, at the
    launch's one slice and over 2 slices, are the JAX package's
    make_mesh(n_data=2, n_model=2[, n_slices=2]) device array;
  * stage-1 steps with the injected global noise, fsdp off and on, against
    the JAX step on make_mesh(n_data=2, n_model=2) (bits/dim rtol 1e-5 at
    step 1, parameters rtol 3e-4 / atol 1e-5 after it, the data-parallel
    trajectory bound of 1e-3 after three); each rank's moments of a partitioned leaf
    are a data slab of its model slab, its bytes the placements';
  * part-parallel stage 2, two parts x n_model = 2 (a (1, 2) mesh a part),
    against the plan on one process (the joint trainer's parts, bit for bit
    in tests/test_torch_part_parallel.py): per-part losses rtol 1e-5, the
    merged parameters and EMA shadows after two steps a part within the
    trajectory bound (rtol 1e-3 / atol 1e-5).
FSDP_MIN_SIZE is lowered to 256 elements in the ranks. Glow L2/K2, width
16, 8x8x3, batch 8; part-parallel: Glow L2/K1/w16, UNets of dim 8 at
16x16, batch 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import one_torch_thread, randomize, run_ranks, to_numpy_tree
from nfdpm_tpu.models import glow as jglow
from nfdpm_tpu.models import prior as jprior
from nfdpm_tpu.parallel import mesh as jmesh
from nfdpm_tpu.training import nf_trainer as jnft
from nfdpm_tpu.training import optim as joptim
from nfdpm_tpu_torch import convert
from nfdpm_tpu_torch.models import formaters as tfmt
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.models.diffusion_prior import DiffusionPrior as TDiffusionPrior
from nfdpm_tpu_torch.models.nf_backbone import NFBackbone
from nfdpm_tpu_torch.parallel import part_parallel as tpp
from nfdpm_tpu_torch.training import diffusion_trainer as tdt

IMG, BATCH, IMG2 = 8, 8, 16
GLOW = dict(in_channels=3, levels=2, steps=2, coupling_width=16, learn_prior=True)
PART_GLOW = dict(in_channels=3, levels=2, steps=1, coupling_width=16)
UNET = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=2)
DIFF = dict(timesteps=8, sampling_timesteps=4, loss_type="l1", beta_schedule="cosine")
RTOL, ATOL, BPD_TOL, TRAJ_RTOL = 3e-4, 1e-5, 1e-5, 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _flat(tree, prefix=""):
    out = {}
    convert._flatten(tree, prefix, out)
    return {k: np.array(v) for k, v in out.items()}


def _sub(out, prefix):
    return {k[len(prefix) + 1:]: v for k, v in out.items() if k.startswith(prefix + "/")}


def _params_close(got, want, rtol=RTOL, atol=ATOL):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_mesh4")
    tree = randomize(to_numpy_tree({"flow": jglow.init_glow(0, jglow.GlowConfig(**GLOW)),
                                    "prior": jprior.init_gaussian_prior(24, True)}), seed=1)
    rng = np.random.default_rng(11)
    imgs = rng.integers(0, 256, (3, BATCH, IMG, IMG, 3)).astype(np.float32) / 255.0
    noise = rng.random(imgs.shape).astype(np.float32)
    convert.save_npz(d / "stage1_tree.npz", tree)
    np.savez(d / "stage1.npz", imgs=imgs, noise=noise)
    part_imgs = rng.integers(0, 256, (4, 4, IMG2, IMG2, 3)).astype(np.float32) / 255.0
    np.savez(d / "part.npz", imgs=part_imgs)
    job = {"scenarios": ["coords", "tp_steps", "part_parallel"], "n_model": 2,
           "also_slices": 2, "fsdp_min_size": 256, "glow": GLOW,
           "stage1_modes": [[False, "noise"], [True, "noise"]],
           # the part-parallel scenario's flow, UNets and data
           "glow2": {"steps": 1}, "img2": IMG2, "unet": UNET, "diff": DIFF}
    out = run_ranks(job, 4, d, timeout_s=240.0)
    return dict(d=d, tree=tree, imgs=imgs, noise=noise, part_imgs=part_imgs, out=out)


@pytest.mark.parametrize("n_slices", [1, 2])
def test_each_ranks_coordinates_are_the_jax_meshs(ranks, n_slices):
    ids = np.vectorize(lambda dev: dev.id)(
        jmesh.make_mesh(n_data=2, n_model=2, n_slices=n_slices).devices)
    name = "mesh" if n_slices == 1 else "slices"
    for r, out in enumerate(ranks["out"]):
        data_rank, model_rank, n_data, n_model = out["coords"][f"{name}/coords"]
        assert (n_data, n_model) == (2, 2) and ids[data_rank, model_rank] == r
        assert list(out["coords"][f"{name}/model_group"]) == list(ids[data_rank])
        assert list(out["coords"][f"{name}/data_group"]) == list(ids[:, model_rank])


@pytest.fixture(scope="module")
def jax_stage1(ranks):
    tx = joptim.make_optimizer("adam", 1e-3, fixed_prior=True)
    step = jnft.make_train_step(jglow.GlowConfig(**GLOW), jnft.NFTrainConfig(lr=1e-3), tx,
                                inject_noise=True)
    mesh = jmesh.make_mesh(n_data=2, n_model=2)
    out = {}
    for fsdp in (False, True):
        params = jax.tree.map(jnp.asarray, ranks["tree"])
        state = {"params": params, "opt_state": tx.init(params),
                 "step": jnp.zeros((), jnp.int32)}
        bpds = []
        with mesh:
            state = jnft.shard_nf_state(mesh, tx, state, fsdp=fsdp)
            for i in range(3):
                state, m = step(state, jmesh.shard_batch(mesh, jnp.asarray(ranks["imgs"][i])),
                                jnp.asarray(ranks["noise"][i]))
                bpds.append(float(m["bpd"]))
                if i == 0:
                    out[f"fsdp{int(fsdp)}/step1"] = _flat(jax.tree.map(np.array,
                                                                       state["params"]))
        out[f"fsdp{int(fsdp)}/bpd"] = np.asarray(bpds)
        out[f"fsdp{int(fsdp)}/step3"] = _flat(to_numpy_tree(state["params"]))
    return out


@pytest.mark.parametrize("fsdp", [0, 1])
def test_stage1_data2_model2_matches_jax_mesh(ranks, jax_stage1, fsdp):
    outs = [o["tp_steps"] for o in ranks["out"]]
    tag = f"noise_fsdp{fsdp}"
    for out in outs[1:]:
        for k in outs[0]:
            if k.startswith((f"{tag}/step", f"{tag}/bpd")):
                np.testing.assert_array_equal(out[k], outs[0][k], err_msg=k)
    r0 = outs[0]
    np.testing.assert_allclose(r0[f"{tag}/bpd"][0], jax_stage1[f"fsdp{fsdp}/bpd"][0],
                               rtol=BPD_TOL)
    np.testing.assert_allclose(r0[f"{tag}/bpd"], jax_stage1[f"fsdp{fsdp}/bpd"], rtol=TRAJ_RTOL)
    _params_close(_sub(r0, f"{tag}/step1"), jax_stage1[f"fsdp{fsdp}/step1"])
    _params_close(_sub(r0, f"{tag}/step3"), jax_stage1[f"fsdp{fsdp}/step3"], rtol=TRAJ_RTOL)
    for out in outs:
        for path, (got, want) in _sub(out, f"{tag}/moment_shape").items():
            assert list(got) == list(want), path
        params, predicted, moments, predicted_moments = out[f"{tag}/bytes"]
        assert params == predicted and moments == predicted_moments
    if fsdp:  # ZeRO halves what the model slabs' moments hold
        assert r0["noise_fsdp1/bytes"][2] < r0["noise_fsdp0/bytes"][2]


def test_part_parallel_with_model_axis_in_each_group_matches_one_process(ranks):
    tdp = TDiffusionPrior(tfmt.IdentityFormater(L=2, in_channels=3, size=IMG2), dict(UNET),
                          dict(DIFF))
    cfg = tglow.GlowConfig(**PART_GLOW)
    tcfg = tdt.DiffusionTrainConfig(lr_diffusion=1e-2, ema_decay=0.5, ema_update_every=1)
    plan = tpp.PartParallelPlan.build(0, NFBackbone(cfg, IMG2, frozen=True),
                                      tglow.init_glow(0, cfg, "cpu"), tdp, tcfg, device="cpu")
    for i, b in enumerate(ranks["part_imgs"]):
        loss = float(plan.step_group(i % 2, b, 7))
        leader = ranks["out"][2 * (i % 2)]["part_parallel"]  # group g: ranks 2g, 2g + 1
        np.testing.assert_allclose(float(leader[f"loss/{i}"]), loss, rtol=1e-5, err_msg=i)
    for prefer_ema in (False, True):
        want = _flat(convert.diffusion_to_jax_params(plan.joint_params(prefer_ema))["diffusion"])
        outs = [_sub(o["part_parallel"], f"ema{int(prefer_ema)}") for o in ranks["out"]]
        for got in outs[1:]:
            for k in want:
                np.testing.assert_array_equal(got[k], outs[0][k], err_msg=k)
        _params_close(outs[0], want, rtol=TRAJ_RTOL)  # two steps a part
