"""GroupNorm on groups split across model ranks (nfdpm_tpu_torch/models/unet.py
GroupNorm, shard_unet_ at any group count) on four gloo ranks on the CPU,
against a whole nn.GroupNorm and against nfdpm_tpu.

One launch (tests/_torch_spatial_scenarios.py: split_groupnorm, split_unet):
  * the norm on a rank's channel slab at (G, n) = (1, 2), (2, 4) and
    (4, 3) with 12 channels (at (4, 3) a rank holds one whole group and a
    third of another), each over its own process group of ranks: the
    output and the gradients of the input, the weight and the bias within
    1e-5 of a whole nn.GroupNorm's;
  * at (data 1, model 2) on ranks 0 and 1, UNets with
    resnet_block_groups=1 (dim 8, mults (1, 2): every Block_0 norm is one
    group split over both ranks): a UNet's output against the JAX
    package's Unet (atol 1e-4, tests/test_torch_unet.py's bound), and two
    stage-2 steps, frozen and co-trained, against one rank: the losses
    within rtol 1e-5, the parameters after them within rtol 1e-3 / atol
    5e-4, the stage-2 bound of tests/test_parallel.py's fsdp diffusion
    test (Adam's first update normalizes each gradient element by its own
    magnitude, so a sum-order difference on a near-zero element moves its
    update by O(lr); the split norm's statistics are summed in another
    order than nn.GroupNorm's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port import jax_diffusion_draws, one_torch_thread, randomize, run_ranks, to_numpy_tree
from nfdpm_tpu.models import formaters as jfmt
from nfdpm_tpu.models import glow as jglow
from nfdpm_tpu.models.diffusion_prior import DiffusionPrior as JDiffusionPrior
from nfdpm_tpu.models.unet import Unet as JUnet
from nfdpm_tpu_torch import convert
from nfdpm_tpu_torch.models import formaters as tfmt
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.models.diffusion_prior import DiffusionPrior as TDiffusionPrior
from nfdpm_tpu_torch.models.nf_backbone import NFBackbone
from nfdpm_tpu_torch.training import diffusion_trainer as tdt

GROUPNORM = [(1, 2), (2, 4), (4, 3)]  # (G, n)
CHANNELS = 12
NORM_TOL = 1e-5
IMG, BATCH = 8, 4
GLOW = dict(in_channels=3, levels=2, steps=1, coupling_width=16, learn_prior=True)
UNET = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=1)
DIFF = dict(timesteps=8, sampling_timesteps=4, loss_type="l1", beta_schedule="cosine")
STAGE2 = [dict(name="frozen", formater="IdentityFormater", frozen=True,
               tcfg=dict(lr_diffusion=1e-3)),
          dict(name="cotrained", formater="IdentityFormater", frozen=False,
               tcfg=dict(lr_diffusion=1e-3, lr_nf=3e-4))]
RTOL, ATOL, LOSS_RTOL, UNET_ATOL = 1e-3, 5e-4, 1e-5, 1e-4


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


def _stage2_inputs(d, conf):
    jformater = jfmt.get_formater(conf["formater"])(L=2, in_channels=3, size=IMG)
    tdp = TDiffusionPrior(tfmt.get_formater(conf["formater"])(L=2, in_channels=3, size=IMG),
                          dict(UNET), dict(DIFF))
    jdp = JDiffusionPrior(jformater, dict(UNET), dict(DIFF))
    unets = {"parts": tuple(convert.unet_to_flax(u) for u in tdp.init_params(2, "cpu")["parts"])}
    tree = randomize(to_numpy_tree({"flow": jglow.init_glow(0, jglow.GlowConfig(**GLOW)),
                                    "diffusion": unets}), seed=3, scale=0.02)
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (2, BATCH, IMG, IMG, 3)).astype(np.float32) / 255.0
    key = jax.random.PRNGKey(11)
    shapes = [(BATCH, *s) for s in jformater.input_shapes]
    draws = [jax_diffusion_draws(key, i, jdp, shapes, (BATCH, IMG, IMG, 3)) for i in range(2)]
    convert.save_npz(d / f"stage2_{conf['name']}_tree.npz", tree)
    flat = {"imgs": imgs}
    for i, dr in enumerate(draws):
        flat[f"dequant_{i}"] = dr["dequant"]
        for j, part in enumerate(dr["parts"]):
            flat.update({f"t_{i}_{j}": part["t"], f"noise_{i}_{j}": part["noise"],
                         f"coin_{i}_{j}": np.asarray(part["self_cond"])})
    np.savez(d / f"stage2_{conf['name']}.npz", **flat)
    return dict(tree=tree, imgs=imgs, draws=draws, tdp=tdp)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("split_groupnorm")
    rng = np.random.default_rng(0)
    norms = {}
    for groups, n in GROUPNORM:
        key = f"{groups}_{n}"
        norms.update({f"{key}/x": rng.standard_normal((2, CHANNELS, 4, 4)).astype(np.float32),
                      f"{key}/g": rng.standard_normal((2, CHANNELS, 4, 4)).astype(np.float32),
                      f"{key}/w": rng.standard_normal(CHANNELS).astype(np.float32),
                      f"{key}/b": rng.standard_normal(CHANNELS).astype(np.float32)})
    np.savez(d / "groupnorm.npz", **norms)
    junet = JUnet(channels=3, **UNET)
    ux = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    ut = rng.integers(0, 10, (4,)).astype(np.int64)
    uparams = randomize(to_numpy_tree(jax.jit(junet.init)(
        jax.random.PRNGKey(1), jnp.asarray(ux), jnp.asarray(ut))["params"]), seed=2, scale=0.02)
    convert.save_npz(d / "unet_tree.npz", uparams)
    np.savez(d / "unet.npz", x=ux, t=ut)
    stage2 = {conf["name"]: _stage2_inputs(d, conf) for conf in STAGE2}
    job = {"scenarios": ["split_groupnorm", "split_unet"], "n_model": 2,
           "groupnorm": GROUPNORM, "glow": GLOW, "glow2": {}, "img2": IMG, "unet": UNET,
           "diff": DIFF, "stage2": STAGE2}
    out = run_ranks(job, 4, d, timeout_s=240.0)
    return dict(out=out, norms=norms, junet=junet, uparams=uparams, ux=ux, ut=ut,
                stage2=stage2)


@pytest.mark.parametrize("groups,n", GROUPNORM)
def test_split_groupnorm_equals_a_whole_groupnorm(ranks, groups, n):
    """Each rank of the group's process group holds the same gathered
    output and gradients, those of nn.GroupNorm over all the channels."""
    key = f"{groups}_{n}"
    a = {k: torch.from_numpy(v) for k, v in ranks["norms"].items() if k.startswith(key + "/")}
    x = a[f"{key}/x"].clone().requires_grad_(True)
    w = a[f"{key}/w"].clone().requires_grad_(True)
    b = a[f"{key}/b"].clone().requires_grad_(True)
    y = F.group_norm(x, groups, w, b, 1e-5)
    (y * a[f"{key}/g"]).sum().backward()
    want = {"y": y.detach(), "dx": x.grad, "dw": w.grad, "db": b.grad}
    for rank in range(n):
        got = ranks["out"][rank]["split_groupnorm"]
        for what, t in want.items():
            np.testing.assert_allclose(got[f"{key}/{what}"], t.numpy(), rtol=0, atol=NORM_TOL,
                                       err_msg=f"rank {rank} {what}")
    assert all(f"{key}/y" not in o["split_groupnorm"] for o in ranks["out"][n:])


def test_unet_of_one_group_at_model2_matches_jax(ranks):
    """resnet_block_groups=1: every column-parallel norm is one group split
    over both ranks."""
    want = ranks["junet"].apply({"params": jax.tree.map(jnp.asarray, ranks["uparams"])},
                                jnp.asarray(ranks["ux"]), jnp.asarray(ranks["ut"]))
    r0, r1 = (o["split_unet"] for o in ranks["out"][:2])
    np.testing.assert_allclose(r0["unet/out"], np.asarray(want), rtol=0, atol=UNET_ATOL)
    np.testing.assert_array_equal(r0["unet/out"], r1["unet/out"])
    assert all("split_unet" not in o or not o["split_unet"] for o in ranks["out"][2:])


@pytest.mark.parametrize("name", ["frozen", "cotrained"])
def test_stage2_step_of_one_group_matches_world1(ranks, name):
    conf = next(c for c in STAGE2 if c["name"] == name)
    s = ranks["stage2"][name]
    tcfg = tdt.DiffusionTrainConfig(**conf["tcfg"])
    tx = tdt.make_two_group_optimizer(tcfg, conf["frozen"])
    bb = NFBackbone(tglow.GlowConfig(**GLOW), IMG, frozen=conf["frozen"])
    params = convert.diffusion_from_jax_params(s["tree"], s["tdp"], "cpu", requires_grad=True)
    params.pop("prior")
    state = {"params": params, "opt_state": tx.init(params), "step": 0}
    step = tdt.make_train_step(bb, s["tdp"], tcfg, tx, inject_noise=True, device="cpu")
    losses = []
    for i in range(len(s["imgs"])):
        state, m = step(state, s["imgs"][i], s["draws"][i])
        losses.append(float(m["loss"]))
    tree = convert.diffusion_to_jax_params(state["params"])
    tree.pop("prior", None)
    want = _flat(tree)
    r0, r1 = (o["split_unet"] for o in ranks["out"][:2])
    for k in r0:
        if k.startswith(name + "/"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    np.testing.assert_allclose(r0[f"{name}/loss"], losses, rtol=LOSS_RTOL)
    got = _sub(r0, f"{name}/params")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)
