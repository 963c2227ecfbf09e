"""The UNet importer of nfdpm_tpu_torch (utils/unet_import.py) against
nfdpm_tpu's (utils/unet_import.py) on the CPU.

A state dict under the original PyTorch repository's names is built from a
JAX flax Unet tree by inverting the JAX importer's name table
(`_torch_port.reference_unet_state_dict`); a UNet of dim 8, [1, 2], 2
groups, 3 channels, with the plain sinusoidal time embedding and with the
learned one. Tolerances: the imported state dict exactly what
convert.unet_from_flax makes of the JAX import (every value distinct, so a
misplaced leaf cannot pass); the UNet forward on imported weights within
tests/test_torch_unet.py's tolerance, atol 1e-4.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (REPO_ROOT, close, one_torch_thread, randomize,
                         reference_unet_state_dict, t, to_numpy_tree)
from nfdpm_tpu.models import unet as junet
from nfdpm_tpu.utils import unet_import as jimport
from nfdpm_tpu_torch import convert
from nfdpm_tpu_torch.models import unet as tunet
from nfdpm_tpu_torch.utils import unet_import as timport

sys.path.insert(0, str(REPO_ROOT))
import chip_smoke  # noqa: E402

IMG, CH, LEVELS = 8, 3, 2
CASES = {"sinusoidal": {},
         "learned": dict(learned_sinusoidal_cond=True, learned_sinusoidal_dim=8)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _kw(case):
    return dict(dim=8, dim_mults=(1, 2), resnet_block_groups=2, channels=CH, **CASES[case])


@pytest.fixture(scope="module", params=list(CASES))
def flax_unet(request):
    """(case, the JAX Unet, its seeded and perturbed flax tree)."""
    jmodel = junet.Unet(**_kw(request.param))
    variables = jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, IMG, IMG, CH)),
                            jnp.zeros((1,), jnp.int32))
    return request.param, jmodel, randomize(to_numpy_tree(variables["params"]), seed=4)


def _distinct(tree):
    """The tree with every value distinct across all leaves."""
    count = [0]

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        a = np.asarray(node)
        values = (count[0] + 1 + np.arange(a.size, dtype=np.float64)) * 1e-4
        count[0] += a.size
        return values.reshape(a.shape).astype(np.float32)

    return walk(tree)


def test_reference_dict_inverts_the_jax_table(flax_unet):
    """The test's own inverse table: the JAX importer takes its dict back to
    the tree it came from."""
    _, _, tree = flax_unet
    back = jimport.import_unet_state_dict(reference_unet_state_dict(tree, LEVELS), LEVELS)
    flat_a, flat_b = {}, {}
    convert._flatten(tree, "", flat_a)
    convert._flatten(back, "", flat_b)
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_b[k], flat_a[k], err_msg=k)


def test_import_equals_the_jax_import_through_convert(flax_unet):
    case, _, tree = flax_unet
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in reference_unet_state_dict(_distinct(tree), LEVELS).items()}
    got = timport.import_unet_state_dict(sd, LEVELS)
    kw = _kw(case)
    want = convert.unet_from_flax(tunet.Unet(**kw), jimport.import_unet_state_dict(sd, LEVELS))
    want = dict(want.named_parameters())
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].shape == v.shape, k
        assert torch.equal(got[k], v.detach()), k
    # every value distinct, and every reference value lands somewhere
    values = torch.cat([v.reshape(-1) for v in got.values()])
    assert values.unique().numel() == values.numel() == sum(v.numel() for v in sd.values())
    module = tunet.Unet(**kw)
    assert not module.load_state_dict(got, strict=True).missing_keys
    if case == "learned":
        assert "time_pos.weights" in got


def test_imported_unet_forward_matches_jax(flax_unet):
    case, jmodel, tree = flax_unet
    sd = reference_unet_state_dict(tree, LEVELS)
    module = tunet.Unet(**_kw(case))
    module.load_state_dict(timport.import_unet_state_dict(sd, LEVELS), strict=True)
    jparams = jax.tree.map(jnp.asarray, jimport.import_unet_state_dict(sd, LEVELS))
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, IMG, IMG, CH)).astype(np.float32)
    steps = np.array([0, 17, 999], np.int32)
    expected = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(x), jnp.asarray(steps)))
    with torch.no_grad():
        got = module(t(x), torch.from_numpy(steps).long())
    close(got, expected, atol=1e-4)


@pytest.mark.parametrize("key", ["downs.0.2.fn.norm.g", "mid_attn.fn.fn.to_out.weight",
                                 "ups.1.3.weight", "time_mlp.3.bias"])
def test_a_missing_key_raises_in_both_packages(flax_unet, key):
    _, _, tree = flax_unet
    sd = reference_unet_state_dict(tree, LEVELS)
    del sd[key]
    with pytest.raises(KeyError):
        jimport.import_unet_state_dict(sd, LEVELS)
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        timport.import_unet_state_dict(sd, LEVELS)


def test_a_key_with_no_place_raises(flax_unet):
    _, _, tree = flax_unet
    sd = reference_unet_state_dict(tree, LEVELS)
    sd["mid_attn.fn.fn.scale"] = np.ones(1, np.float32)
    with pytest.raises(KeyError, match="no place"):
        timport.import_unet_state_dict(sd, LEVELS)


def test_chip_smoke_name_table_matches(flax_unet):
    """chip_smoke.py writes a port Unet under the reference's names with a
    table of its own (phase 26): the same dict as this file's inverse of
    the JAX importer's table."""
    case, _, tree = flax_unet
    module = convert.unet_from_flax(tunet.Unet(**_kw(case)), _distinct(tree))
    got = chip_smoke.reference_unet_state_dict(module)
    want = reference_unet_state_dict(_distinct(tree), LEVELS)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
