"""The port's FID Inception-v3 against the JAX package's, on the CPU.

One JAX network is built and compiled per file, at two images a call: the
JAX package's `inception.random_params()` with every convolution kernel
times sqrt(2) (He's scale: the features are O(0.3) instead of the 4e-4 of
flax's LeCun init, so the tolerance is not larger than the values), carried
across by `convert.inception_from_flax`.
- Features of two uint8 images at 299: rtol 1e-3 / atol 2e-3 (the
  tolerance of tests/test_weight_importers.py's Inception cross-check).
- The port's state-dict keys are torchvision's (the JAX package's torch
  mirror), a pt_inception-style file loads strictly.
- The whole slice through each package's real Inception: evaluate_model of
  both on 16 sampler images, one mode: KID, SSIM and PSNR within rtol 1e-3,
  the same keys. FID is left out here: on 16 samples of 2048-d features its
  covariances are singular, so its value is too ill-conditioned to compare
  (tests/test_torch_metrics.py holds it on full-rank features), and each
  2048x2048 sqrtm takes tens of seconds of CPU.
"""

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread
from nfdpm_tpu.metrics import compute as jcompute
from nfdpm_tpu.metrics import inception as jinception
from nfdpm_tpu.metrics import torch_inception
from nfdpm_tpu_torch import convert
from nfdpm_tpu_torch.metrics import compute as tcompute
from nfdpm_tpu_torch.metrics import inception as tinception


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def nets():
    """(JAX feature fn, the port's feature fn, the flax tree as numpy)."""
    import jax

    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) * (np.sqrt(2.0) if path[-1].key == "kernel" else 1.0),
        jinception.random_params())
    model = tinception.FIDInceptionV3().eval()
    model.load_state_dict(convert.inception_from_flax(tree), strict=True)
    return jinception.make_feature_fn(tree), tinception.make_feature_fn(model, "cpu"), tree


def test_features_match_jax(nets):
    jfn, tfn, _ = nets
    imgs = np.random.default_rng(0).integers(0, 256, (2, 299, 299, 3)).astype(np.uint8)
    ref = np.asarray(jfn(imgs))
    ours = tfn(torch.from_numpy(imgs).float())
    assert ours.shape == (2, tinception.FEATURE_DIM)
    assert 0.05 < float(np.abs(ref).mean()) < 5.0
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-3, atol=2e-3)


def test_state_dict_keys_are_torchvisions():
    mirror = torch_inception.build_feature_model().state_dict()
    ours = tinception.FIDInceptionV3().state_dict()
    assert list(ours) == list(mirror)
    model = tinception.FIDInceptionV3()
    model.load_state_dict(mirror, strict=True)
    flax_keys = set(convert.inception_from_flax(
        {"Mixed_5b": {"branch1x1": {"conv": {"kernel": np.zeros((1, 1, 192, 64))},
                                    "bn_var": np.ones(64)}}}))
    assert flax_keys == {"Mixed_5b.branch1x1.conv.weight", "Mixed_5b.branch1x1.bn.running_var",
                         "Mixed_5b.branch1x1.bn.num_batches_tracked"}
    with pytest.raises(KeyError, match="no Inception parameter"):
        convert.inception_from_flax({"fc": {"kernel": np.zeros((2, 2))}})


def test_load_weights_reads_a_pt_inception_file(tmp_path):
    """The .pth holds the classifier heads too, and may lack the step counters."""
    sd = tinception.random_init(3).state_dict()
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    sd["fc.weight"], sd["AuxLogits.fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
    torch.save(sd, tmp_path / tinception.WEIGHTS_FILE)
    loaded = tinception.load_weights(str(tmp_path / tinception.WEIGHTS_FILE)).state_dict()
    for k, v in sd.items():
        if not k.startswith(tinception.UNUSED_PREFIXES):
            assert torch.equal(loaded[k], v), k
    sd["Mixed_5b.extra.weight"] = torch.zeros(1)
    torch.save(sd, tmp_path / "bad.pth")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        tinception.load_weights(str(tmp_path / "bad.pth"))


def test_evaluate_model_through_inception_matches_jax(tmp_path, monkeypatch, nets):
    jfn, tfn, _ = nets
    monkeypatch.setitem(jcompute._EXTRACTOR_CACHE, "inception_v3", jfn)
    monkeypatch.setitem(tcompute._EXTRACTOR_CACHE, "inception_v3", tfn)
    stats = str(tmp_path)
    # two images a feature-net call throughout: one JAX compilation
    jcompute.make_custom_stats(None, "", "synthetic", "train", 32, "legacy_tensorflow",
                               "inception_v3", batch_size=2, stats_dir=stats, limit=16)
    generated = np.random.default_rng(8).integers(0, 256, (16, 32, 32, 3)).astype(np.uint8)
    loader_imgs = np.random.default_rng(9).uniform(0, 1, (16, 32, 32, 3)).astype(np.float32)
    loader = [(loader_imgs[i: i + 8], np.zeros(8, np.int64)) for i in (0, 8)]
    config = [{"mode": "legacy_tensorflow", "model_name": "inception_v3"}]
    common = dict(data_name="synthetic", dataset_res=32, batch_size=2, num_gen=16,
                  dataset_split="train", kid_kwargs=config,
                  ssim_psnr_kwargs={"data_range": 255, "loader": loader}, stats_dir=stats,
                  gen_batch_size=16)

    def sampler():
        pos = [0]

        def sample_images(n):
            pos[0] += n
            return generated[pos[0] - n: pos[0]]

        return sample_images

    ref = jcompute.evaluate_model(sample_images=sampler(), **common)
    ours = tcompute.evaluate_model(sample_images=sampler(), device="cpu", **common)
    assert set(ours) == set(ref) == {"KID_inception", "SSIM", "PSNR"}
    assert all(np.isfinite(v) for v in ours.values())
    for key in ("KID_inception", "SSIM", "PSNR"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-3, err_msg=key)
