"""Checkpoints of the original PyTorch repository into and out of
nfdpm_tpu_torch (utils/reference_import.py, utils/reference_export.py),
held against nfdpm_tpu's importer and exporter on the CPU.

The reference state dicts are made by the JAX package's own
export_glow_state_dict from seeded, perturbed JAX parameters (a Glow
L3/K2, coupling width 24, as tests/test_reference_export.py), so no
reference file is read. Tolerances: the imported trees exactly equal
(PLU factors included: both packages run scipy's LU on the same float32
weight); bits/dim of one batch through both packages within 1e-4; the
export's values exactly equal except the reassembled 1x1 weight (an fp32
P @ L @ U' in torch against XLA's), atol 1e-6 as the JAX package's test;
the port's own round trip as tests/test_reference_export.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, randomize, t, to_numpy_tree
from nfdpm_tpu.models import glow as jglow
from nfdpm_tpu.models import prior as jprior
from nfdpm_tpu.training import nf_trainer as jnft
from nfdpm_tpu.utils import reference_export as jexport
from nfdpm_tpu.utils import reference_import as jimport
from nfdpm_tpu_torch import convert, inference
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.ops.bijectors import invconv_weight
from nfdpm_tpu_torch.utils import reference_export as texport
from nfdpm_tpu_torch.utils import reference_import as timport

GLOW = dict(in_channels=3, levels=3, steps=2, coupling_width=24)
IMG, BATCH = 8, 4
PARAMS = ["plu", "full"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _jax_tree(invconv_param, seed=0):
    """Seeded, perturbed JAX {"flow", "prior"} (numpy) of the test Glow."""
    cfg = jglow.GlowConfig(invconv_param=invconv_param, **GLOW)
    prior = jprior.init_gaussian_prior(tglow.final_channels(tglow.GlowConfig(**GLOW)), True)
    return randomize(to_numpy_tree({"flow": jglow.init_glow(seed, cfg), "prior": prior}),
                     seed=seed + 1)


@pytest.fixture(scope="module", params=PARAMS)
def reference(request):
    """(invconv_param, the JAX tree, the reference flow and prior state
    dicts as a .pt would hold them: CPU tensors)."""
    tree = _jax_tree(request.param)
    flow = jexport.export_glow_state_dict(tree["flow"], GLOW["levels"], GLOW["steps"])
    prior = jexport.export_gaussian_prior_state_dict(tree["prior"])
    as_torch = lambda sd: {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    return request.param, tree, as_torch(flow), as_torch(prior)


def _named(tree):
    return {k: (v.detach().contiguous().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in convert.named_leaves(tree)}


def _imports(reference):
    param, _, flow_sd, prior_sd = reference
    L, K = GLOW["levels"], GLOW["steps"]
    want = {"flow": jimport.import_glow_state_dict(flow_sd, L, K, invconv_param=param),
            "prior": jimport.import_gaussian_prior_state_dict(prior_sd)}
    got = {"flow": timport.import_glow_state_dict(flow_sd, L, K, invconv_param=param),
           "prior": timport.import_gaussian_prior_state_dict(prior_sd)}
    return want, got


# -- import ------------------------------------------------------------------

def test_glow_import_equals_the_jax_import_exactly(reference):
    want, got = _imports(reference)
    want = _named(convert.from_jax_params(want, "cpu"))
    got_leaves = _named(got)
    assert got_leaves.keys() == want.keys()
    for k, v in want.items():
        assert got_leaves[k].dtype == np.float32 and got_leaves[k].shape == v.shape, k
        np.testing.assert_array_equal(got_leaves[k], v, err_msg=k)
    if reference[0] == "plu":
        assert {"p_mat", "lower", "upper", "log_s", "sign"} == set(
            got["flow"]["final_steps"][0]["invconv"])


def test_numpy_values_import_as_tensors_do(reference):
    param, _, flow_sd, _ = reference
    as_numpy = {k: v.numpy() for k, v in flow_sd.items()}
    a = _named(timport.import_glow_state_dict(flow_sd, 3, 2, invconv_param=param))
    b = _named(timport.import_glow_state_dict(as_numpy, 3, 2, invconv_param=param))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_imported_glow_bits_per_dim_matches_jax(reference):
    param = reference[0]
    want, got = _imports(reference)
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (BATCH, IMG, IMG, 3)).astype(np.float32) / 255.0
    key, salt = jax.random.PRNGKey(4), np.int32(2)
    jcfg = jglow.GlowConfig(invconv_param=param, **GLOW)
    bpd_j = jnft.make_eval_step(jcfg, jnft.NFTrainConfig())(
        jax.tree.map(jnp.asarray, want), jnp.asarray(imgs), key, salt)
    noise = np.asarray(jax.random.uniform(jax.random.fold_in(key, salt), imgs.shape))
    tcfg = tglow.GlowConfig(invconv_param=param, **GLOW)
    params = convert.tree_to_device(got, torch.device("cpu"))
    bpd_t = inference.make_eval_step(tcfg, 5, device="cpu")(params, t(imgs), noise=noise)
    np.testing.assert_allclose(bpd_t.numpy(), np.asarray(bpd_j), atol=1e-4, rtol=0)


def test_prior_fold_is_exact():
    prior = {"bias": np.random.default_rng(1).normal(size=48).astype(np.float32),
             "logs": np.random.default_rng(2).normal(size=48).astype(np.float32)}
    sd = {k: torch.from_numpy(v) for k, v in
          jexport.export_gaussian_prior_state_dict(prior).items()}
    got = timport.import_gaussian_prior_state_dict(sd)
    want = jimport.import_gaussian_prior_state_dict(sd)
    for k in ("bias", "logs"):
        np.testing.assert_array_equal(got[k], prior[k])
        np.testing.assert_array_equal(got[k], want[k])


def test_nonzero_prior_conv_weight_is_refused_by_both_packages():
    prior = {"bias": np.zeros(12, np.float32), "logs": np.zeros(12, np.float32)}
    sd = jexport.export_gaussian_prior_state_dict(prior)
    sd["_GaussianPrior__conv.weight"] = sd["_GaussianPrior__conv.weight"].copy()
    sd["_GaussianPrior__conv.weight"][3, 1, 0, 2] = 1e-3
    with pytest.raises(AssertionError, match="nonzero"):
        jimport.import_gaussian_prior_state_dict(sd)
    with pytest.raises(ValueError, match="nonzero"):
        timport.import_gaussian_prior_state_dict(sd)


# -- export ------------------------------------------------------------------

def test_export_equals_the_jax_export(reference):
    param, tree, _, _ = reference
    want = jexport.export_glow_state_dict(tree["flow"], GLOW["levels"], GLOW["steps"])
    params = convert.from_jax_params(tree, "cpu")
    got = texport.export_glow_state_dict(params["flow"], GLOW["levels"], GLOW["steps"])
    assert list(got) == list(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        if k.endswith("invconv2d.weight") and param == "plu":
            np.testing.assert_allclose(got[k], v, atol=1e-6, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    got_prior = texport.export_gaussian_prior_state_dict(params["prior"])
    want_prior = jexport.export_gaussian_prior_state_dict(tree["prior"])
    assert got_prior.keys() == want_prior.keys()
    for k in want_prior:
        assert got_prior[k].dtype == want_prior[k].dtype
        np.testing.assert_array_equal(got_prior[k], want_prior[k], err_msg=k)
    assert texport.adam_skeleton(got, 3e-4) == jexport.adam_skeleton(want, 3e-4)


@pytest.mark.parametrize("param", PARAMS)
def test_export_import_round_trip(param):
    """The port's counterpart of tests/test_reference_export.py's round
    trip: every leaf back exactly, the 1x1 weights within 1e-5 (the PLU
    factors may come back permuted otherwise)."""
    tree = convert.from_jax_params(_jax_tree(param, seed=5), "cpu")
    sd = texport.export_glow_state_dict(tree["flow"], GLOW["levels"], GLOW["steps"])
    back = timport.import_glow_state_dict(sd, GLOW["levels"], GLOW["steps"], invconv_param=param)
    a, b = _named(tree["flow"]), _named(back)
    assert a.keys() == b.keys()
    for k in a:
        if "/invconv/" not in k:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)

    def invconvs(flow):
        for block in flow["blocks"]:
            yield from (s["invconv"] for s in block["steps"])
        yield from (s["invconv"] for s in flow["final_steps"])

    for inv_a, inv_b in zip(invconvs(tree["flow"]), invconvs(back)):
        inv_b = {k: torch.from_numpy(v) for k, v in inv_b.items()}
        np.testing.assert_allclose(invconv_weight(inv_b).numpy(),
                                   invconv_weight(inv_a).numpy(), atol=1e-5, rtol=0)


def test_learn_prior_false_is_refused():
    cfg = tglow.GlowConfig(in_channels=3, levels=2, steps=1, coupling_width=8,
                           learn_prior=False)
    flow = tglow.init_glow(0, cfg, "cpu")
    assert flow["blocks"][0]["split"]["conv"] is None
    with pytest.raises(ValueError, match="split prior"):
        texport.export_glow_state_dict(flow, cfg.levels, cfg.steps)
