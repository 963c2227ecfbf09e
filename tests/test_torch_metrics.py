"""nfdpm_tpu_torch.metrics against nfdpm_tpu.metrics on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and its counterpart in the port:
- SSIM and PSNR: rtol 2e-5 (the JAX golden tests' own);
- TF1 bilinear resize: atol 2e-4 on [0, 255] values; clean (PIL) resize:
  equal;
- Frechet distance, feature stats, KID: rtol 1e-12 (the same numpy code);
- stats files written by either package read by the other, array for array;
- the whole slice, `evaluate_model` of both packages on the same sampler
  images, stats file, loader batches and one injected feature function (a
  seeded projection of the resized pixels to 16 dimensions, so that the
  covariances have full rank): FID and KID within rtol 1e-6, SSIM and
  PSNR within their own 2e-5;
- the trainers' hook `make_nf_evaluate_fn`: sample counts, the salts that
  reach the sampler, imagenet32's test -> val split, {} and a warning
  without stats.
"""

import logging

import numpy as np
import pytest
import torch

from _torch_port import inject_features, one_torch_thread
from nfdpm_tpu.metrics import compute as jcompute
from nfdpm_tpu.metrics import fid as jfid
from nfdpm_tpu.metrics import image_quality as jiq
from nfdpm_tpu_torch.metrics import compute as tcompute
from nfdpm_tpu_torch.metrics import fid as tfid
from nfdpm_tpu_torch.metrics import image_quality as tiq


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _images(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


# ---------------------------------------------------------------------------
# SSIM / PSNR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad", ["reflect", "valid"])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("size", [8, 32])
def test_ssim_matches_jax(pad, channels, size):
    if pad == "valid" and size == 8:
        size = 16  # an 11x11 window needs more than 8 pixels without padding
    rng = np.random.default_rng(size * 10 + channels)
    target = rng.uniform(0, 255, (3, size, size, channels)).astype(np.float32)
    pred = np.clip(target + rng.normal(0, 20, target.shape), 0, 255).astype(np.float32)
    ours = tiq.ssim(torch.from_numpy(pred), torch.from_numpy(target), 255.0, pad)
    assert ours.dim() == 0
    np.testing.assert_allclose(float(ours), float(jiq.ssim(pred, target, 255.0, pad)),
                               rtol=2e-5)


@pytest.mark.parametrize("data_range", [1.0, 255.0])
def test_psnr_matches_jax(data_range):
    rng = np.random.default_rng(7)
    target = rng.uniform(0, data_range, (4, 16, 16, 3)).astype(np.float32)
    pred = target + rng.normal(0, 0.05 * data_range, target.shape).astype(np.float32)
    pred[0] = target[0]  # MSE 0: the 1e-12 clamp
    ours = tiq.psnr(torch.from_numpy(pred), torch.from_numpy(target), data_range)
    assert ours.dim() == 0
    np.testing.assert_allclose(float(ours), float(jiq.psnr(pred, target, data_range)),
                               rtol=2e-5)


# ---------------------------------------------------------------------------
# Resizing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src", [32, 28])
def test_tf1_bilinear_resize_matches_jax(src):
    imgs = _images(src, (2, src, src, 3))
    ours = tfid.tf1_bilinear_resize(torch.from_numpy(imgs), 299)
    assert ours.dtype == torch.float32 and ours.shape == (2, 299, 299, 3)
    ref = jfid.tf1_bilinear_resize(imgs.astype(np.float32), 299)
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-4, rtol=0)
    assert not np.array_equal(np.round(ref), ref)  # fractional, never re-quantised


@pytest.mark.parametrize("mode", ["clean", "legacy_tensorflow"])
def test_resize_batch_matches_jax(mode):
    imgs = _images(3, (2, 32, 32, 3))
    ours = tfid.resize_batch(imgs, 64, mode, "cpu").numpy()
    ref = jfid.resize_batch(imgs, 64, mode)
    if mode == "clean":
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=0)
    same = tfid.resize_batch(imgs, 32, mode, "cpu")
    np.testing.assert_array_equal(same.numpy(), imgs.astype(np.float32))
    with pytest.raises(ValueError, match="Unknown resize mode"):
        tfid.resize_batch(imgs, 64, "nearest", "cpu")


def test_extract_features_matches_jax_with_one_feature_fn():
    """Gray images become RGB, batches are cut the same way."""
    imgs = _images(4, (5, 16, 16, 1))
    w = np.random.default_rng(0).standard_normal((24 * 24 * 3, 4)).astype(np.float32)

    def feats(x):
        return np.asarray(x, np.float32).reshape(len(x), -1) @ w

    ours = tfid.extract_features(imgs, lambda x: torch.from_numpy(feats(x.numpy())), 24,
                                 "clean", batch_size=2, device="cpu")
    ref = jfid.extract_features(imgs, lambda x: feats(x), 24, "clean", batch_size=2)
    np.testing.assert_array_equal(ours, ref)


# ---------------------------------------------------------------------------
# Score math and the stats store
# ---------------------------------------------------------------------------

def test_score_math_matches_jax():
    rng = np.random.default_rng(11)
    a = rng.normal(size=(300, 12)).astype(np.float32)
    b = (rng.normal(size=(200, 12)) * 1.3 + 0.2).astype(np.float32)
    (mu_a, s_a), (mu_b, s_b) = tfid.feature_stats(a), tfid.feature_stats(b)
    for ours, ref in zip((mu_a, s_a, mu_b, s_b), (*jfid.feature_stats(a),
                                                  *jfid.feature_stats(b))):
        np.testing.assert_allclose(ours, ref, rtol=1e-12)
    np.testing.assert_allclose(tfid.frechet_distance(mu_a, s_a, mu_b, s_b),
                               jfid.frechet_distance(mu_a, s_a, mu_b, s_b), rtol=1e-12)
    for kw in ({}, {"num_subsets": 7, "max_subset_size": 50, "seed": 3}):
        np.testing.assert_allclose(tfid.kid_score(a, b, **kw), jfid.kid_score(a, b, **kw),
                                   rtol=1e-12)


def test_stats_files_cross_read(tmp_path):
    rng = np.random.default_rng(5)
    fa = rng.normal(size=(40, 6)).astype(np.float32)
    fb = rng.normal(size=(30, 6)).astype(np.float32)
    d = str(tmp_path)
    key = ("cifar10", "clean", "clip_vit_b_32", "train", 32)
    assert tfid.stat_filename(*key) == jfid.stat_filename(*key)
    tfid.save_stats(fa, *key, stats_dir=d)
    jfid.save_stats(fb, "cifar10", "legacy_tensorflow", "inception_v3", "test", 32, d)
    ref = jfid.load_stats(*key, stats_dir=d)
    ours = tfid.load_stats("cifar10", "legacy_tensorflow", "inception_v3", "test", 32, d)
    for got, feats in ((ref, fa), (ours, fb)):
        assert set(got) == {"mu", "sigma", "feats"}
        np.testing.assert_array_equal(got["feats"], feats)
    for name in ("mu", "sigma"):
        np.testing.assert_array_equal(ref[name], tfid.feature_stats(fa)[0 if name == "mu"
                                                                        else 1])
    assert tfid.stats_exist(*key, stats_dir=d) and jfid.stats_exist(*key, stats_dir=d)
    assert tfid.load_stats("cifar10", "clean", "inception_v3", "train", 64, d) is None
    tfid.remove_all_stats(d)
    assert not jfid.stats_exist(*key, stats_dir=d)


def test_stats_dir_comes_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("NFDPM_TPU_STATS_DIR", str(tmp_path / "stats"))
    path = tfid.save_stats(np.zeros((3, 2), np.float32), "synthetic", "clean",
                           "inception_v3", "train", 8)
    assert path == str(tmp_path / "stats" / "synthetic_clean_train_8.npz")
    monkeypatch.delenv("NFDPM_TPU_STATS_DIR")
    assert tfid.default_stats_dir() == jfid.DEFAULT_STATS_DIR


# ---------------------------------------------------------------------------
# The whole slice: evaluate_model of both packages, one feature function
# ---------------------------------------------------------------------------

@pytest.fixture
def injected(monkeypatch):
    """One feature function in both packages' extractor caches."""
    return inject_features(monkeypatch, jcompute._EXTRACTOR_CACHE, tcompute._EXTRACTOR_CACHE)


def _sampler(images):
    pos = [0]

    def sample_images(n):
        out = images[pos[0]: pos[0] + n]
        pos[0] += n
        return out

    return sample_images


def test_evaluate_model_matches_jax(tmp_path, injected):
    stats = str(tmp_path)
    configs = [{"mode": "legacy_tensorflow", "model_name": "inception_v3"},
               {"mode": "clean", "model_name": "inception_v3"}]
    for c in configs:
        jcompute.make_custom_stats(None, "", "synthetic", "train", 32, c["mode"],
                                   "inception_v3", batch_size=64, stats_dir=stats, limit=128)
    generated = _images(21, (64, 32, 32, 3))
    loader_imgs = np.random.default_rng(22).uniform(0, 1, (64, 32, 32, 3)).astype(np.float32)
    loader = [(loader_imgs[i: i + 16], np.zeros(16, np.int64)) for i in range(0, 64, 16)]
    common = dict(data_name="synthetic", dataset_res=32, batch_size=32, num_gen=64,
                  dataset_split="train", fid_kwargs=configs, kid_kwargs=configs,
                  ssim_psnr_kwargs={"data_range": 255, "loader": loader}, stats_dir=stats,
                  gen_batch_size=32)
    ref = jcompute.evaluate_model(sample_images=_sampler(generated), **common)
    ours = tcompute.evaluate_model(sample_images=_sampler(generated), device="cpu", **common)
    assert set(ours) == set(ref) == {"FID_inception", "FID_clean_inception", "KID_inception",
                                     "KID_clean_inception", "SSIM", "PSNR"}
    for key in ref:
        assert np.isfinite(ours[key]), key
        # SSIM/PSNR take no features: they keep their own bound (the conv's
        # sum order; this SSIM is 0.005, a difference of near-equal terms)
        rtol = 2e-5 if key in ("SSIM", "PSNR") else 1e-6
        np.testing.assert_allclose(ours[key], ref[key], rtol=rtol, err_msg=key)


def test_port_stats_match_jax_stats(tmp_path, injected):
    """precompute_statistics of the port writes what make_custom_stats of
    the JAX package writes, under the same name."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jcompute.make_custom_stats(None, "", "synthetic", "train", 32, "legacy_tensorflow",
                               "inception_v3", stats_dir=jd, limit=40)
    tcompute.precompute_statistics(None, "", "synthetic", "train", 32, "legacy_tensorflow",
                                   "inception_v3", stats_dir=td, limit=40, device="cpu")
    a = jfid.load_stats("synthetic", "legacy_tensorflow", "inception_v3", "train", 32, jd)
    b = tfid.load_stats("synthetic", "legacy_tensorflow", "inception_v3", "train", 32, td)
    for name in ("mu", "sigma", "feats"):
        np.testing.assert_allclose(b[name], a[name], rtol=1e-5, atol=1e-7, err_msg=name)


def test_evaluate_model_refuses_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcompute.evaluate_model(sample_images=None, data_name="synthetic", dataset_res=32,
                                batch_size=8, num_gen=8, dataset_split="train")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcompute.make_nf_evaluate_fn(data_name="synthetic", loaders=None, fid_configs=[],
                                     kid_configs=[], img_size=8, temperature=1.0,
                                     logger=None)


def test_missing_weights_file_is_named_in_a_warning(tmp_path, monkeypatch, caplog):
    monkeypatch.setenv("NFDPM_TPU_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setattr(tcompute, "_EXTRACTOR_CACHE", {})
    tiny = tcompute.clip_features.random_init(0, patch=16, width=32, layers=1, heads=2,
                                              out_dim=8, image_size=32)
    monkeypatch.setattr(tcompute.clip_features, "random_init", lambda seed: tiny)
    with caplog.at_level(logging.WARNING, logger=tcompute.__name__):
        fn = tcompute.get_feature_extractor("clip_vit_b_32", "cpu")
    assert str(tmp_path / "ViT-B-32.pt") in caplog.text
    assert fn(torch.zeros(2, 32, 32, 3)).shape == (2, 8)
    assert tcompute.get_feature_extractor("clip_vit_b_32", "cpu") is fn
    with pytest.raises(ValueError, match="Unknown feature model"):
        tcompute.get_feature_extractor("resnet", "cpu")


# ---------------------------------------------------------------------------
# The trainers' hook
# ---------------------------------------------------------------------------

class _Logger:
    def __init__(self):
        self.infos, self.warnings = [], []

    def info(self, msg):
        self.infos.append(msg)

    def warning(self, msg):
        self.warnings.append(msg)


class _Loaders:
    eval = [(np.full((4, 8, 8, 3), 0.5, np.float32), np.zeros(4, np.int64))]


def _hook(data_name="cifar10", split="train", **kw):
    return tcompute.make_nf_evaluate_fn(
        data_name=data_name, loaders=_Loaders(), fid_configs=[],
        kid_configs=[{"mode": "legacy_tensorflow", "model_name": "inception_v3"}],
        img_size=8, temperature=0.7, logger=_Logger(), quick_num_gen=5,
        dataset_split=split, device="cpu", **kw)


@pytest.mark.parametrize("data_name,split,full,expected", [
    ("cifar10", "train", False, ("train", 5)),
    ("cifar10", "train", True, ("train", 50000)),
    ("cifar10", "test", True, ("test", 10000)),
    ("imagenet32", "test", True, ("val", 10000)),
    ("synthetic", "train", True, ("train", 5)),  # no dataset size: the quick count
])
def test_evaluate_fn_counts_and_split(monkeypatch, data_name, split, full, expected):
    seen = {}
    monkeypatch.setattr(tcompute, "evaluate_model", lambda **kw: seen.update(kw) or {})
    _hook(data_name, split)(None, None, 2, full=full)
    assert (seen["dataset_split"], seen["num_gen"]) == expected
    assert seen["batch_size"] == 32 and seen["gen_batch_size"] == 256


def test_evaluate_fn_salts_and_ssim(tmp_path, injected):
    """Each sampler call of one evaluation gets salt epoch * 100003 + call
    index; the device uint8 images reach the metrics as numpy."""
    tcompute.make_custom_stats(None, "", "synthetic", "train", 8, "legacy_tensorflow",
                               "inception_v3", stats_dir=str(tmp_path), limit=40,
                               device="cpu")
    calls = []

    def sample_fn(params, n, temperature, salt):
        calls.append((params, n, temperature, salt))
        gen = torch.Generator().manual_seed(salt)
        return torch.randint(0, 256, (n, 8, 8, 3), generator=gen, dtype=torch.uint8)

    fn = tcompute.make_nf_evaluate_fn(
        data_name="synthetic", loaders=_Loaders(), fid_configs=[],
        kid_configs=[{"mode": "legacy_tensorflow", "model_name": "inception_v3"}],
        img_size=8, temperature=0.7, logger=_Logger(), quick_num_gen=70,
        ssim_psnr={"data_range": 255}, gen_batch_size=8, stats_dir=str(tmp_path),
        device="cpu")
    metrics = fn(sample_fn, "params", 3)
    assert [c[3] for c in calls] == [300_009, 300_010, 300_011]
    assert [c[1] for c in calls] == [32, 32, 6]  # the generation batch is at least 32
    assert all(c[0] == "params" and c[2] == 0.7 for c in calls)
    assert set(metrics) == {"KID_inception", "SSIM", "PSNR"}
    assert all(np.isfinite(v) for v in metrics.values())


def test_evaluate_fn_without_stats_warns_and_returns_nothing(tmp_path, injected):
    logger = _Logger()
    fn =tcompute.make_nf_evaluate_fn(
        data_name="synthetic", loaders=_Loaders(), fid_configs=[],
        kid_configs=[{"mode": "clean", "model_name": "inception_v3"}], img_size=8,
        temperature=1.0, logger=logger, quick_num_gen=4, stats_dir=str(tmp_path),
        device="cpu")
    sampled = []
    assert fn(lambda *a: sampled.append(a) or torch.zeros(4, 8, 8, 3, dtype=torch.uint8),
              None, 1) == {}
    assert not sampled and len(logger.warnings) == 1
    assert "no precomputed stats" in logger.warnings[0]
    assert "synthetic/clean/inception_v3/train/8" in logger.warnings[0]


# ---------------------------------------------------------------------------
# The stats command line
# ---------------------------------------------------------------------------

def test_precompute_stats_command_line(tmp_path, monkeypatch, injected):
    from nfdpm_tpu_torch.metrics import precompute_stats

    argv = ["--action", "precompute", "--datasets", "synthetic", "--models", "inception_v3",
            "--limit", "20", "--stats_dir", str(tmp_path)]
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            precompute_stats.main(argv)
    precompute_stats.main(argv + ["--device", "cpu"])
    # --data-parallel over the one device --device names: the same statistics
    dp_dir = tmp_path.with_name(tmp_path.name + "_data_parallel")
    dp_argv = [a if a != str(tmp_path) else str(dp_dir) for a in argv]
    precompute_stats.main(dp_argv + ["--data-parallel", "--device", "cpu"])
    assert len(list(dp_dir.iterdir())) == 2
    for f in dp_dir.iterdir():
        with np.load(f) as a, np.load(tmp_path / f.name) as b:
            for key in ("mu", "sigma", "feats"):
                np.testing.assert_array_equal(a[key], b[key])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "synthetic_clean_train_32.npz", "synthetic_legacy_tensorflow_train_32.npz"]
    ref = jcompute.load_dataset_images("synthetic", "", "train", 32, 20)
    feats = tfid.load_stats("synthetic", "clean", "inception_v3", "train", 32,
                            str(tmp_path))["feats"]
    np.testing.assert_allclose(feats, injected(jfid.resize_batch(ref, 299, "clean")),
                               rtol=1e-6)
    precompute_stats.main(["--action", "clean", "--stats_dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("net", ["inception", "clip"])
def test_feature_nets_turn_tf32_off(net):
    """cuDNN's default TF32 convolutions keep about three digits; the
    feature nets run in full fp32, as the JAX package's do."""
    from nfdpm_tpu_torch.metrics import clip_features, inception

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    if net == "inception":
        inception.make_feature_fn(inception.FIDInceptionV3(), "cpu")
    else:
        clip_features.make_feature_fn(clip_features.VisionTransformer(
            patch=16, width=32, layers=1, heads=2, out_dim=8, image_size=32), "cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
