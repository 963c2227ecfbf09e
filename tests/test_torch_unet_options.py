"""The UNet's options `stacked_mid_attn` and `remat` in nfdpm_tpu_torch held
against nfdpm_tpu on the CPU.

  * Unet(stacked_mid_attn=True) and Unet(remat=True) against the JAX
    package's Unet with the same options and the same parameters (flax
    init, randomized, through the strict converter): the output, and the
    gradients of a loss of it (every parameter and the input) against
    jax.grad. The stacked mid Attention alone against the JAX module.
  * remat's gradients bitwise equal to those without it, and the same
    parameters (the option adds none).
  * Two gloo ranks, one launch (tests/_torch_unet_option_scenarios.py):
    two stage-2 steps with remat at (data 1, model 2) with
    resnet_block_groups=1 (every Block_0 norm one group split over both
    ranks) and on a data axis of two with fsdp (each UNet block gathered on
    use; leaves of 256 elements or more partitioned), against one process:
    losses within rtol 1e-5, parameters after within rtol 1e-3 / atol 5e-4
    (test_torch_split_groupnorm.py's stage-2 bound against world 1);
    remat's own parameters bitwise those without it at the same mesh; each
    rank's collectives of a step the same on both ranks, and with remat
    those without it plus the ones a ResnetBlock unit makes in the forward
    (its gather and its forward, run again in the recompute).
  * A diffusion_architecture.json with both keys builds its UNets through
    training/runload.py.
Tolerances: the output atol 1e-5 (the JAX package's own apply of the same
UNet with and without the option agrees bitwise), gradients rtol 1e-4 /
atol 1e-6 of each leaf's largest entry.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_diffusion_draws, one_torch_thread, randomize, run_ranks, t
from _torch_port import to_numpy_tree
from nfdpm_tpu.models import formaters as jfmt
from nfdpm_tpu.models import glow as jglow
from nfdpm_tpu.models import unet as junet
from nfdpm_tpu.models.diffusion_prior import DiffusionPrior as JDiffusionPrior
from nfdpm_tpu_torch import convert
from nfdpm_tpu_torch.models import formaters as tfmt
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.models import unet as tunet
from nfdpm_tpu_torch.models.diffusion_prior import DiffusionPrior as TDiffusionPrior
from nfdpm_tpu_torch.models.nf_backbone import NFBackbone
from nfdpm_tpu_torch.training import diffusion_trainer as tdt
from nfdpm_tpu_torch.training import runload


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


OUT_ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
IMG, CH, BATCH = 8, 6, 3
OPTIONS = {"stacked": dict(stacked_mid_attn=True), "remat": dict(remat=True),
           "both": dict(stacked_mid_attn=True, remat=True)}


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module", params=list(OPTIONS))
def pair(request):
    kw = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=2, channels=CH,
              **OPTIONS[request.param])
    jmodel = junet.Unet(**kw)
    tree = randomize(to_numpy_tree(jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, IMG, IMG, CH)),
                                               jnp.zeros((1,), jnp.int32))["params"]),
                     seed=4, scale=0.05)
    tmodel = convert.unet_from_flax(tunet.Unet(**kw), tree)
    x, g = _rand(5, BATCH, IMG, IMG, CH), _rand(6, BATCH, IMG, IMG, CH)
    steps = np.array([0, 17, 999], np.int32)
    return dict(kw=kw, jmodel=jmodel, tree=tree, tmodel=tmodel, x=x, g=g, steps=steps)


def _jax_out(p, x):
    return p["jmodel"].apply({"params": jax.tree.map(jnp.asarray, p["tree"])}, x,
                             jnp.asarray(p["steps"]))


def _port_grads(model, x, steps, g):
    """The output, and d(sum(g * out))/d(parameter) by name plus the input's."""
    for q in model.parameters():
        q.grad = None
    model.requires_grad_(True)
    xt = t(x).requires_grad_(True)
    out = model(xt, torch.from_numpy(steps).long())
    (out * t(g)).sum().backward()
    grads = {n: q.grad.clone() for n, q in model.named_parameters()}
    model.requires_grad_(False)
    return out.detach(), grads, xt.grad


def test_output_matches_jax(pair):
    want = np.asarray(_jax_out(pair, jnp.asarray(pair["x"])))
    with torch.no_grad():
        got = pair["tmodel"](t(pair["x"]), torch.from_numpy(pair["steps"]).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OUT_ATOL)


def test_gradients_match_jax(pair):
    def loss(params, x):
        out = pair["jmodel"].apply({"params": params}, x, jnp.asarray(pair["steps"]))
        return jnp.sum(out * jnp.asarray(pair["g"]))

    gp, gx = jax.grad(loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, pair["tree"]),
                                            jnp.asarray(pair["x"]))
    model = pair["tmodel"]
    _, grads, x_grad = _port_grads(model, pair["x"], pair["steps"], pair["g"])
    probe = tunet.Unet(**pair["kw"])
    for name, q in probe.named_parameters():  # the port's gradients in the flax layout
        q.data = grads[name]
    want = jax.tree.leaves(jax.tree.map(np.asarray, gp))
    got = jax.tree.leaves(convert.unet_to_flax(probe))
    assert len(got) == len(want)
    for a, b in zip(got + [x_grad.numpy()], want + [np.asarray(gx)]):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=GRAD_RTOL * float(np.abs(b).max()) + GRAD_ATOL)


def test_stacked_mid_attention_matches_jax_module():
    x = _rand(7, 2, 4, 4, 16)
    module = junet.Attention(stacked=True)
    params = randomize(to_numpy_tree(module.init(jax.random.PRNGKey(8), jnp.asarray(x))["params"]),
                       seed=9, scale=0.05)
    want = np.asarray(module.apply({"params": jax.tree.map(jnp.asarray, params)},
                                   jnp.asarray(x)))
    attn = tunet.Attention(16, stacked=True)
    with torch.no_grad():
        attn.w_qkv.copy_(torch.from_numpy(params["Conv_0"]["kernel"][0, 0]))
        attn.w_out.copy_(torch.from_numpy(params["Conv_1"]["kernel"][0, 0]))
        attn.b_out.copy_(torch.from_numpy(params["Conv_1"]["bias"]))
        got = attn(t(x))
        plain = tunet.Attention(16)
        plain.load_state_dict(attn.state_dict())
        unstacked = plain(t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(got.numpy(), unstacked.numpy(), rtol=0, atol=OUT_ATOL)


@pytest.mark.parametrize("stacked", [False, True])
def test_remat_gradients_bitwise_equal_without_it(stacked):
    kw = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=2, channels=CH,
              stacked_mid_attn=stacked)
    plain = tunet.init_unet_(tunet.Unet(**kw), 11)
    remat = tunet.Unet(**kw, remat=True)
    remat.load_state_dict(plain.state_dict())  # the same parameters, by the same names
    assert [n for n, _ in remat.named_parameters()] == [n for n, _ in plain.named_parameters()]
    x, g, steps = _rand(12, 2, IMG, IMG, CH), _rand(13, 2, IMG, IMG, CH), np.array([3, 500])
    out_a, grads_a, gx_a = _port_grads(plain, x, steps, g)
    out_b, grads_b, gx_b = _port_grads(remat, x, steps, g)
    assert torch.equal(out_a, out_b) and torch.equal(gx_a, gx_b)
    for name in grads_a:
        assert torch.equal(grads_a[name], grads_b[name]), name


# -- remat on two gloo ranks ----------------------------------------------------------

GLOW = dict(in_channels=3, levels=2, steps=1, coupling_width=16, learn_prior=True)
UNET_SPLIT = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=1)
DIFF = dict(timesteps=8, sampling_timesteps=4, loss_type="l1", beta_schedule="cosine")
STAGE2 = dict(name="frozen", formater="IdentityFormater", frozen=True,
              tcfg=dict(lr_diffusion=1e-3))
RTOL, ATOL, LOSS_RTOL = 1e-3, 5e-4, 1e-5
KINDS = ("all_reduce", "all_gather", "fsdp_gather", "fsdp_reduce_scatter")


def _flat(tree, prefix=""):
    out = {}
    convert._flatten(tree, prefix, out)
    return {k: np.array(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("remat_unet")
    jformater = jfmt.get_formater(STAGE2["formater"])(L=2, in_channels=3, size=IMG)
    tdp = TDiffusionPrior(tfmt.get_formater(STAGE2["formater"])(L=2, in_channels=3, size=IMG),
                          dict(UNET_SPLIT), dict(DIFF))
    jdp = JDiffusionPrior(jformater, dict(UNET_SPLIT), dict(DIFF))
    unets = {"parts": tuple(convert.unet_to_flax(u) for u in tdp.init_params(2, "cpu")["parts"])}
    tree = randomize(to_numpy_tree({"flow": jglow.init_glow(0, jglow.GlowConfig(**GLOW)),
                                    "diffusion": unets}), seed=3, scale=0.02)
    imgs = np.random.default_rng(5).integers(0, 256, (2, 4, IMG, IMG, 3)).astype(np.float32) / 255
    shapes = [(4, *s) for s in jformater.input_shapes]
    draws = [jax_diffusion_draws(jax.random.PRNGKey(11), i, jdp, shapes, (4, IMG, IMG, 3))
             for i in range(2)]
    convert.save_npz(d / "stage2_frozen_tree.npz", tree)
    flat = {"imgs": imgs}
    for i, dr in enumerate(draws):
        flat[f"dequant_{i}"] = dr["dequant"]
        for j, part in enumerate(dr["parts"]):
            flat.update({f"t_{i}_{j}": part["t"], f"noise_{i}_{j}": part["noise"],
                         f"coin_{i}_{j}": np.asarray(part["self_cond"])})
    np.savez(d / "stage2_frozen.npz", **flat)
    job = {"scenarios": ["remat_unet"], "n_model": 2, "fsdp_min_size": 256, "glow": GLOW,
           "glow2": {}, "img2": IMG,
           "unet": UNET_SPLIT, "diff": DIFF, "stage2": [STAGE2]}
    out = run_ranks(job, 2, d, timeout_s=240.0)
    return dict(out=[o["remat_unet"] for o in out], tree=tree, imgs=imgs, draws=draws, tdp=tdp)


@pytest.fixture(scope="module")
def world1(ranks):
    """The same two steps in one process, remat on."""
    tdp = TDiffusionPrior(ranks["tdp"].formater, dict(UNET_SPLIT, remat=True), dict(DIFF))
    tcfg = tdt.DiffusionTrainConfig(**STAGE2["tcfg"])
    tx = tdt.make_two_group_optimizer(tcfg, True)
    params = convert.diffusion_from_jax_params(ranks["tree"], tdp, "cpu", requires_grad=True)
    params.pop("prior")
    state = {"params": params, "opt_state": tx.init(params), "step": 0}
    step = tdt.make_train_step(NFBackbone(tglow.GlowConfig(**GLOW), IMG, frozen=True), tdp, tcfg,
                               tx, inject_noise=True, device="cpu")
    losses = []
    for i in range(2):
        state, m = step(state, ranks["imgs"][i], ranks["draws"][i])
        losses.append(float(m["loss"]))
    tree = convert.diffusion_to_jax_params(state["params"])
    tree.pop("prior", None)
    return dict(losses=losses, params=_flat(tree))


@pytest.mark.parametrize("mesh", ["model2", "fsdp"])
def test_remat_steps_on_two_ranks_match_one_process(ranks, world1, mesh):
    r0, r1 = ranks["out"]
    tag = f"{mesh}_remat1"
    np.testing.assert_allclose(r0[f"{tag}/loss"], world1["losses"], rtol=LOSS_RTOL)
    np.testing.assert_array_equal(r0[f"{tag}/loss"], r1[f"{tag}/loss"])
    got = {k[len(tag) + 8:]: v for k, v in r0.items() if k.startswith(f"{tag}/params/")}
    assert got.keys() == world1["params"].keys()
    for k, want in world1["params"].items():
        np.testing.assert_allclose(got[k], want, rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_array_equal(r1[f"{tag}/params/{k}"], got[k], err_msg=k)


@pytest.mark.parametrize("mesh", ["model2", "fsdp"])
def test_remat_on_two_ranks_bitwise_equal_without_it(ranks, mesh):
    r0 = ranks["out"][0]
    for k in r0:
        if k.startswith(f"{mesh}_remat1/") and "collectives" not in k:
            np.testing.assert_array_equal(r0[k], r0[k.replace("_remat1/", "_remat0/")],
                                          err_msg=k)


@pytest.mark.parametrize("mesh", ["model2", "fsdp"])
def test_remat_runs_the_blocks_collectives_again(ranks, mesh):
    """The recompute runs each ResnetBlock unit's forward collectives again:
    the model group's split-norm and row-parallel all-reduces at model 2,
    fsdp's gathers on a data axis (FSDP_MIN_SIZE lowered to 256 elements,
    so that the tiny UNets' leaves are partitioned); the same counts on both
    ranks."""
    r0, r1 = ranks["out"]
    for tag in (f"{mesh}_remat0", f"{mesh}_remat1"):
        np.testing.assert_array_equal(r0[f"{tag}/collectives"], r1[f"{tag}/collectives"])
    plain, remat = r0[f"{mesh}_remat0/collectives"], r0[f"{mesh}_remat1/collectives"]
    in_block = r0[f"{mesh}_remat0/collectives_in_block"]
    np.testing.assert_array_equal(remat, plain + in_block)
    kind = KINDS.index("all_reduce" if mesh == "model2" else "fsdp_gather")
    assert in_block[kind] > 0


def test_architecture_json_with_both_keys_builds_through_runload(tmp_path):
    arch = {"kind": "diffusion_prior",
            "flow": {"L": 2, "K": 1, "in_channels": 3, "coupling_width": 16,
                     "learn_prior": True, "invconv_param": "plu", "img_size": IMG},
            "formater": "IdentityFormater",
            "unet_kwargs": {"dim": 8, "dim_mults": [1, 2], "resnet_block_groups": 2,
                            "stacked_mid_attn": True, "remat": True},
            "diffusion_kwargs": dict(DIFF), "frozen": True, "n_bits": 5, "temperature": 1.0}
    path = tmp_path / "diffusion_architecture.json"
    path.write_text(json.dumps(arch))
    _, dp = runload.build_diffusion_model(json.loads(path.read_text()))
    unets = dp.init_params(0, "cpu")["parts"]
    assert len(unets) == dp.num_parts == 2
    for u in unets:
        assert u.remat and u.mid_attn.fn.stacked
