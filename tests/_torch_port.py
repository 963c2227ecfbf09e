"""Shared helpers for the tests that hold nfdpm_tpu_torch against nfdpm_tpu.

Inputs and weights are made with numpy from a seed and handed to both
packages; JAX runs on the CPU, PyTorch on the CPU (device="cpu")."""

from __future__ import annotations

import contextlib

import jax
import numpy as np
import torch

# Leaves a Glow starts with at zero (actnorms, zeroconvs, priors). Tests give
# them small random values so that no part of a step is the identity. The
# permutation matrix and the sign of a PLU 1x1 conv stay as they are.
_FIXED = ("p_mat", "sign")


def randomize(tree, seed: int, scale: float = 0.05):
    """Add seeded N(0, scale^2) noise to every leaf but p_mat and sign."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        if node is None or name in _FIXED:
            return node
        a = np.asarray(node, np.float32)
        return (a + scale * rng.standard_normal(a.shape)).astype(np.float32)

    return walk(tree)


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_tree(tree):
    """A JAX-layout sub-tree (one step, a zeroconv, a coupling net) -> the
    port's layout on the CPU: conv weights "w" HWIO -> OIHW."""
    from nfdpm_tpu_torch.convert import tree_to_device

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if name == "w":
            return np.asarray(node, np.float32).transpose(3, 2, 0, 1)
        return node

    return tree_to_device(walk(to_numpy_tree(tree)), torch.device("cpu"))


def t(a) -> torch.Tensor:
    """numpy/JAX array -> CPU fp32 tensor."""
    return torch.from_numpy(np.array(a, np.float32))


def close(actual, expected, atol=1e-5, rtol=0.0):
    a = actual.detach().cpu().numpy() if isinstance(actual, torch.Tensor) else np.asarray(actual)
    np.testing.assert_allclose(a, np.asarray(expected), atol=atol, rtol=rtol)


def adam_moments(opt_state, params):
    """(mu, nu, count) of the optax state of nfdpm_tpu's make_optimizer, as
    numpy trees shaped like `params`, with zeros where optax masks a leaf
    out (p_mat, sign and, under fixed_prior, the prior)."""
    import optax

    found = []

    def visit(node):
        if isinstance(node, optax.ScaleByAdamState):
            found.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, (tuple, list)):  # named tuples of optax included
            for v in node:
                visit(v)

    visit(opt_state)
    (state,) = found

    def fill(moment, like):
        if isinstance(like, dict):
            return {k: fill(moment[k] if isinstance(moment, dict) and k in moment else None, v)
                    for k, v in like.items()}
        if isinstance(like, (tuple, list)):
            given = isinstance(moment, (tuple, list))
            return type(like)(fill(moment[i] if given else None, v)
                              for i, v in enumerate(like))
        if like is None:
            return None
        if moment is None or isinstance(moment, optax.MaskedNode):
            return np.zeros(np.shape(like), np.float32)
        return np.asarray(moment)

    return fill(state.mu, params), fill(state.nu, params), int(state.count)


def reference_unet_state_dict(tree, n_levels):
    """A flax Unet tree of the JAX package (numpy) under the names and
    layouts of the original PyTorch repository's Unet: the inverse of the
    table of nfdpm_tpu/utils/unet_import.py (conv kernels HWIO -> OIHW,
    dense kernels [in, out] -> [out, in], norm gains [C] -> [1, C, 1, 1])."""
    sd = {}

    def conv(prefix, node):
        sd[f"{prefix}.weight"] = np.asarray(node["kernel"]).transpose(3, 2, 0, 1)
        if "bias" in node:
            sd[f"{prefix}.bias"] = np.asarray(node["bias"])

    def dense(prefix, node):
        sd[f"{prefix}.weight"] = np.asarray(node["kernel"]).T
        sd[f"{prefix}.bias"] = np.asarray(node["bias"])

    def gain(key, node):
        sd[key] = np.asarray(node["ChannelLayerNorm_0"]["g"]).reshape(1, -1, 1, 1)

    def res(prefix, node):
        dense(f"{prefix}.mlp.1", node["Dense_0"])
        for j in (0, 1):
            block = node[f"Block_{j}"]
            conv(f"{prefix}.block{j + 1}.proj", block["WeightStandardizedConv_0"])
            sd[f"{prefix}.block{j + 1}.norm.weight"] = np.asarray(block["GroupNorm_0"]["scale"])
            sd[f"{prefix}.block{j + 1}.norm.bias"] = np.asarray(block["GroupNorm_0"]["bias"])
        if "Conv_0" in node:
            conv(f"{prefix}.res_conv", node["Conv_0"])

    def attention(prefix, node, linear):
        conv(f"{prefix}.to_qkv", node["Conv_0"])
        if linear:
            conv(f"{prefix}.to_out.0", node["Conv_1"])
            gain(f"{prefix}.to_out.1.g", node)
        else:
            conv(f"{prefix}.to_out", node["Conv_1"])

    convs = iter(range(1, 4))
    conv("init_conv", tree["Conv_0"])
    if "RandomOrLearnedSinusoidalPosEmb_0" in tree:
        sd["time_mlp.0.weights"] = np.asarray(tree["RandomOrLearnedSinusoidalPosEmb_0"]["weights"])
    dense("time_mlp.1", tree["Dense_0"])
    dense("time_mlp.3", tree["Dense_1"])
    for i in range(n_levels):
        res(f"downs.{i}.0", tree[f"down_{i}_res1"])
        res(f"downs.{i}.1", tree[f"down_{i}_res2"])
        gain(f"downs.{i}.2.fn.norm.g", tree[f"PreNormResidual_{i}"])
        attention(f"downs.{i}.2.fn.fn", tree[f"LinearAttention_{i}"], True)
        if f"Downsample_{i}" in tree:
            conv(f"downs.{i}.3.1", tree[f"Downsample_{i}"]["Conv_0"])
        else:
            conv(f"downs.{i}.3", tree[f"Conv_{next(convs)}"])
    res("mid_block1", tree["mid_res1"])
    gain("mid_attn.fn.norm.g", tree[f"PreNormResidual_{n_levels}"])
    attention("mid_attn.fn.fn", tree["Attention_0"], False)
    res("mid_block2", tree["mid_res2"])
    for i in range(n_levels):
        res(f"ups.{i}.0", tree[f"up_{i}_res1"])
        res(f"ups.{i}.1", tree[f"up_{i}_res2"])
        gain(f"ups.{i}.2.fn.norm.g", tree[f"PreNormResidual_{n_levels + 1 + i}"])
        attention(f"ups.{i}.2.fn.fn", tree[f"LinearAttention_{n_levels + i}"], True)
        if f"Upsample_{i}" in tree:
            conv(f"ups.{i}.3.1", tree[f"Upsample_{i}"]["Conv_0"])
        else:
            conv(f"ups.{i}.3", tree[f"Conv_{next(convs)}"])
    res("final_res_block", tree["final_res"])
    conv("final_conv", tree[f"Conv_{next(convs)}"])
    return sd


def jax_diffusion_draws(key, step, jdp, shapes, image_shape):
    """The draws of the JAX package's stage-2 train step `step` from `key`
    (diffusion_trainer.make_train_step, DiffusionPrior.losses,
    GaussianDiffusion.loss and p_losses) for a batch of `image_shape`
    [B, H, W, C] and latent parts of `shapes`, as the port's injected
    draws."""
    k_dq, k_diff = jax.random.split(jax.random.fold_in(key, step))
    parts = []
    for i, (shape, gd) in enumerate(zip(shapes, jdp.parts)):
        k_t, k_p = jax.random.split(jax.random.fold_in(k_diff, i))
        t = jax.random.randint(k_t, (image_shape[0],), 0, gd.num_timesteps)
        k_noise, _, k_scdrop = jax.random.split(k_p, 3)
        parts.append({"t": np.asarray(t), "noise": np.asarray(jax.random.normal(k_noise, shape)),
                      "self_cond": bool(jax.random.bernoulli(k_scdrop))})
    return {"dequant": np.asarray(jax.random.uniform(k_dq, image_shape)), "parts": parts}


# -- a small analytic model in place of the UNet, written in both frameworks,
# so that a diffusion process compiles in a second --------------------------

def model_weights(c, out, seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((c, out)) / np.sqrt(c)).astype(np.float32),
            "s": (0.5 * rng.standard_normal((c, out)) / np.sqrt(c)).astype(np.float32)}


def jax_model(p, x, steps, sc):
    """tanh(x W + 0.1 sin(0.37 t) + sc S); t [B] or length 1."""
    import jax.numpy as jnp

    h = x @ p["w"] + 0.1 * jnp.sin(0.37 * steps.astype(jnp.float32)).reshape(-1, 1, 1, 1)
    if sc is not None:
        h = h + sc @ p["s"]
    return jnp.tanh(h)


def torch_model(p, x, steps, sc):
    h = x @ p["w"] + 0.1 * torch.sin(0.37 * steps.float()).reshape(-1, 1, 1, 1)
    if sc is not None:
        h = h + sc @ p["s"]
    return torch.tanh(h)


@contextlib.contextmanager
def one_torch_thread():
    """PyTorch on one CPU thread: at the tests' tiny sizes its thread pool
    costs more than it gives, the more so beside other test workers (a
    stage-2 CPU training run took 1.3 s on one thread and 35 s on eight of a
    loaded 8-core host)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def projected_features(dim: int = 16, res: int = 299, seed: int = 2024):
    """A feature function in place of Inception for the metrics' tests: a
    seeded projection of the resized [0, 255] pixels [B, res, res, 3] to
    `dim` values (numpy in, float32 numpy out). With more samples than
    `dim` the covariances have full rank, so FID is well-conditioned."""
    w = np.random.default_rng(seed).standard_normal((res * res * 3, dim))
    w = (w / np.sqrt(res * res * 3) / 128.0).astype(np.float32)

    def feats(x):
        x = np.asarray(x, np.float32).reshape(len(x), -1)
        return np.tanh(x @ w).astype(np.float32)

    return feats


def inject_features(monkeypatch, *caches, model_name: str = "inception_v3"):
    """Put one projected feature function into each extractor cache: the
    JAX package's takes arrays, the port's (the last) torch tensors."""
    feats = projected_features()
    for cache in caches[:-1]:
        monkeypatch.setitem(cache, model_name, lambda x: feats(x))
    monkeypatch.setitem(caches[-1], model_name,
                        lambda x: torch.from_numpy(feats(x.cpu().numpy())))
    return feats


def metric_overrides(*metrics, quick_num_gen=40):
    """Each metric in both resize modes through the feature net
    inception_v3, and SSIM/PSNR."""
    out = []
    for m in metrics:
        out += [f"model.evaluation.metrics.{m}.mode=[legacy_tensorflow,clean]",
                f"model.evaluation.metrics.{m}.model_name=[inception_v3,inception_v3]"]
    return out + ["model.evaluation.metrics.SSIM_and_PSNR.data_range=255",
                  f"model.evaluation.quick_num_gen={quick_num_gen}"]


def precompute_stats(monkeypatch, stats_dir, img_size):
    """The port's precompute_statistics over synthetic images in both
    modes, with a projected feature function in place of Inception."""
    monkeypatch.setenv("NFDPM_TPU_STATS_DIR", str(stats_dir))
    from nfdpm_tpu_torch.metrics import compute as tcompute

    inject_features(monkeypatch, tcompute._EXTRACTOR_CACHE)
    for mode in ("legacy_tensorflow", "clean"):
        tcompute.precompute_statistics(None, "", "synthetic", "train", img_size, mode,
                                       "inception_v3", limit=64, device="cpu")


# -- run directories of the JAX package, written on the CPU (orbax) ------------

REPO_ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
RUN_GLOW = dict(in_channels=3, levels=2, steps=2, coupling_width=16)
RUN_IMG = 8
RUN_DATA = ["data.name=synthetic", "data.synthetic_fallback=true", "data.batch_size=8",
            f"data.img_size={RUN_IMG}", "data.synthetic_n=32"]
RUN_UNET = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=2)
RUN_DIFF = dict(timesteps=6, sampling_timesteps=3, loss_type="l1", beta_schedule="cosine",
                ddim_sampling_eta=1.0, scan_unroll=1, sampling_method="auto",
                vlb_time_chunk=4)


def _write_config(run_dir, root_yaml, overrides):
    from nfdpm_tpu.utils.config import load_config

    cfg = load_config(str(REPO_ROOT / "configs" / root_yaml), overrides)
    (run_dir / "config.yaml").write_text(cfg.to_yaml())


def write_jax_glow_run(run_dir, epochs=(1,), temperature=0.7):
    """A stage-1 run directory as the JAX package writes it: architecture.json,
    config.yaml and orbax checkpoints model_gaussian_<e> of seeded weights
    ({"params", "opt_state", "step"}, the state of the entry point's
    optimizer: Adam, fixed prior). Returns {epoch: numpy params}."""
    from nfdpm_tpu.models import glow as jglow
    from nfdpm_tpu.models import prior as jprior
    from nfdpm_tpu.training import checkpoint as jckpt
    from nfdpm_tpu.training import nf_trainer as jnft
    from nfdpm_tpu_torch.models.glow import final_channels

    run_dir.mkdir(parents=True, exist_ok=True)
    cfg = jglow.GlowConfig(**RUN_GLOW)
    jckpt.save_architecture(str(run_dir), {
        "L": cfg.levels, "K": cfg.steps, "in_channels": cfg.in_channels, "img_size": RUN_IMG,
        "coupling_width": cfg.coupling_width, "learn_prior": cfg.learn_prior, "n_bits": 5,
        "fixed_prior": True, "temperature": temperature, "optimizer": "adam",
        "invconv_param": cfg.invconv_param})
    _write_config(run_dir, "nf_base.yaml", RUN_DATA + [
        f"model.architecture.L={cfg.levels}", f"model.architecture.K={cfg.steps}",
        f"model.architecture.coupling_width={cfg.coupling_width}",
        f"model.training.temperature={temperature}"])
    tx = jnft.make_optimizer("adam", 1e-3, fixed_prior=True)
    out = {}
    for epoch in epochs:
        tree = randomize(to_numpy_tree({
            "flow": jglow.init_glow(0, cfg),
            "prior": jprior.init_gaussian_prior(final_channels(cfg), True)}),
            seed=epoch)
        params = jax.tree.map(jax.numpy.asarray, tree)
        jckpt.save_state(str(run_dir), "gaussian", epoch, {
            "params": params, "opt_state": tx.init(params), "step": np.int32(4 * epoch)})
        out[epoch] = tree
    return out


def write_jax_diffusion_run(run_dir, formater="IdentityFormater", ema=True):
    """A stage-2 run directory as the JAX package's entry point writes it:
    diffusion_architecture.json, config.yaml and one orbax checkpoint
    model_diffusion_001 of seeded weights and the fresh state of the entry
    point's optimizer (two groups, the flow frozen), with an EMA shadow of
    the UNets that differs from them. The UNet trees come from the port's
    seeded init through convert.unet_to_flax (flax's init compiles for
    seconds).
    Returns (numpy params, numpy EMA tree or None, the architecture dict)."""
    from nfdpm_tpu.models import glow as jglow
    from nfdpm_tpu.training import checkpoint as jckpt
    from nfdpm_tpu.training import diffusion_trainer as jdt
    from nfdpm_tpu_torch import convert
    from nfdpm_tpu_torch.models import formaters as tfmt
    from nfdpm_tpu_torch.models.diffusion_prior import DiffusionPrior as TDiffusionPrior

    run_dir.mkdir(parents=True, exist_ok=True)
    arch = {"kind": "diffusion_prior",
            "flow": dict(L=RUN_GLOW["levels"], K=RUN_GLOW["steps"], in_channels=3,
                         coupling_width=RUN_GLOW["coupling_width"], learn_prior=True,
                         invconv_param="plu", img_size=RUN_IMG),
            "formater": formater, "formater_stats": None,
            "unet_kwargs": dict(RUN_UNET, dim_mults=list(RUN_UNET["dim_mults"]),
                                learned_sinusoidal_cond=False, random_fourier_features=False,
                                learned_sinusoidal_dim=16, learned_variance=False,
                                dtype="float32"),
            "diffusion_kwargs": dict(RUN_DIFF), "frozen": True, "n_bits": 5,
            "temperature": 1.0}
    jckpt.save_architecture(str(run_dir), arch, filename="diffusion_architecture.json")
    _write_config(run_dir, "nf_diffusion.yaml", RUN_DATA + [
        "model.normalizing_flow.init_nf.mode=scratch",
        f"model.normalizing_flow.init_nf.scratch.L={RUN_GLOW['levels']}",
        f"model.normalizing_flow.init_nf.scratch.K={RUN_GLOW['steps']}",
        f"model.normalizing_flow.init_nf.scratch.coupling_width={RUN_GLOW['coupling_width']}",
        f"model.normalizing_flow.latent_formater={formater}",
        f"model.unet.dim={RUN_UNET['dim']}", "model.unet.dim_mults=[1,2]",
        f"model.unet.resnet_block_groups={RUN_UNET['resnet_block_groups']}",
        f"model.diffusion.timesteps={RUN_DIFF['timesteps']}",
        f"model.diffusion.sampling_timesteps={RUN_DIFF['sampling_timesteps']}"])
    tformater = tfmt.get_formater(formater)(L=RUN_GLOW["levels"], in_channels=3, size=RUN_IMG)
    tdp = TDiffusionPrior(tformater, dict(RUN_UNET), dict(RUN_DIFF))
    unets = {"parts": tuple(convert.unet_to_flax(u)
                            for u in tdp.init_params(2, "cpu")["parts"])}
    tree = randomize(to_numpy_tree({"flow": jglow.init_glow(0, jglow.GlowConfig(**RUN_GLOW)),
                                    "diffusion": unets}), seed=3, scale=0.02)
    params = jax.tree.map(jax.numpy.asarray, tree)
    tx = jdt.make_two_group_optimizer(jdt.DiffusionTrainConfig(), frozen=True)
    state = {"params": params, "opt_state": tx.init(params), "step": np.int32(9)}
    shadow = None
    if ema:
        shadow = randomize({"diffusion": tree["diffusion"]}, seed=4, scale=0.01)
        state["ema"] = jax.tree.map(jax.numpy.asarray, shadow)
    jckpt.save_state(str(run_dir), "diffusion", 1, state)
    return tree, shadow, arch


# -- interrupts -------------------------------------------------------------------

class InterruptAfter:
    """Loader proxy raising KeyboardInterrupt before yielding batch n of any
    epoch (Ctrl-C in the middle of an epoch), as tests/test_resume.py's."""

    def __init__(self, loader, n):
        self._loader, self._n = loader, n

    def __getattr__(self, name):
        return getattr(self._loader, name)

    def __len__(self):
        return len(self._loader)

    def __iter__(self):
        return iter(self._loader)

    def iter_epoch(self, epoch, start_batch=0):
        for i, item in enumerate(self._loader.iter_epoch(epoch, start_batch=start_batch)):
            if start_batch + i >= self._n:
                raise KeyboardInterrupt
            yield item


def interrupt_train_loader(loaders, n):
    """The same loaders, the train loader interrupted before batch n."""
    return type(loaders)(train=InterruptAfter(loaders.train, n), val=loaders.val,
                         test=loaders.test, eval=loaders.eval)


def interrupt_loaders_after(monkeypatch, n):
    """Make the port's read_dataset, which the entry points call, interrupt
    its train loader before batch n; returns the function that undoes it."""
    from nfdpm_tpu_torch.data import pipeline

    read = pipeline.read_dataset
    monkeypatch.setattr(pipeline, "read_dataset",
                        lambda *a, **kw: interrupt_train_loader(read(*a, **kw), n))
    return lambda: monkeypatch.setattr(pipeline, "read_dataset", read)
