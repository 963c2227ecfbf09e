"""The port's CLIP ViT-B/32 image features against the JAX package's, on the CPU.

- The JAX package's `clip_features.random_params()` at full size, carried
  across by `convert.clip_from_flax`: unit-norm features of two uint8
  images at 224 within rtol 1e-3 / atol 2e-3 (the tolerance of
  tests/test_weight_importers.py's CLIP cross-check).
- The port's parameter names are OpenAI's `CLIP.visual` names (the JAX
  package's torch mirror), and `load_weights` reads the `visual.*` half of
  a checkpoint both as a TorchScript archive and as a plain state dict (a
  small tower keeps this cheap; the names are the same at every size).
"""

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread
from nfdpm_tpu.metrics import clip_features as jclip
from nfdpm_tpu.metrics import torch_clip
from nfdpm_tpu_torch import convert
from nfdpm_tpu_torch.metrics import clip_features as tclip

SMALL = dict(patch=16, width=32, layers=2, heads=2, out_dim=8, image_size=32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def test_features_match_jax():
    import jax

    tree = jax.tree.map(np.asarray, jclip.random_params())
    model = tclip.VisionTransformer().eval()
    model.load_state_dict(convert.clip_from_flax(tree), strict=True)
    imgs = np.random.default_rng(0).integers(0, 256, (2, 224, 224, 3)).astype(np.uint8)
    ref = np.asarray(jclip.make_feature_fn(tree)(imgs))
    ours = tclip.make_feature_fn(model, "cpu")(torch.from_numpy(imgs).float())
    assert ours.shape == (2, tclip.FEATURE_DIM)
    np.testing.assert_allclose(ours.norm(dim=-1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-3, atol=2e-3)
    with pytest.raises(KeyError, match="no CLIP parameter"):
        convert.clip_from_flax({"block_0": {"attn": {"qkv": {"kernel": np.zeros((2, 2))}}}})


def test_parameter_names_are_openais():
    ours = tclip.VisionTransformer().state_dict()
    mirror = torch_clip.build_visual_model().state_dict()
    assert set(ours) == set(mirror)
    assert all(ours[k].shape == mirror[k].shape for k in ours)


class _CLIP(torch.nn.Module):
    """What OpenAI's archive holds: the visual tower under `visual`, beside
    a text side."""

    def __init__(self, visual):
        super().__init__()
        self.visual = visual
        self.token_embedding = torch.nn.Embedding(10, 4)

    def forward(self, x):
        return self.visual(x)


@pytest.mark.parametrize("kind", ["torchscript", "state_dict"])
def test_load_weights_reads_both_checkpoint_forms(tmp_path, kind):
    source = tclip.random_init(5, **SMALL)
    path = tmp_path / tclip.WEIGHTS_FILE
    full = _CLIP(source).eval()
    if kind == "torchscript":
        torch.jit.save(torch.jit.trace(full, torch.zeros(1, 3, 32, 32)), str(path))
    else:
        torch.save(full.state_dict(), path)
    loaded = tclip.load_weights(str(path), **SMALL)
    for k, v in source.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    x = torch.rand(2, 32, 32, 3) * 255
    np.testing.assert_array_equal(tclip.make_feature_fn(loaded, "cpu")(x).numpy(),
                                  tclip.make_feature_fn(source, "cpu")(x).numpy())
