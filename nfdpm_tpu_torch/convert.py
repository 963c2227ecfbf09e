"""Weight bridge between the JAX package's parameter trees and the port's.

The JAX tree (nfdpm_tpu/models/glow.py:init_glow plus the prior of
training/nf_trainer.py:init_train_state), as nested dicts and tuples of
numpy arrays:

    {"flow": {"blocks": ({"steps": <K-stacked step>, "split": {"conv": zc | None}}, ...),
              "final_steps": <K-stacked step>},
     "prior": {"bias", "logs"} | {}}

The port's tree has the same keys, with each K-stacked step unstacked into a
list of K steps and every conv weight "w" turned from HWIO into OIHW. The
1x1-conv leaves (PLU p_mat/lower/upper/log_s/sign, or full-W "weight")
pass through unchanged.

`trainable` marks a tree's leaves for autograd (all but the PLU constants),
and `opt_state_from_jax`/`opt_state_to_jax` carry Adam's moments and step
count across in the same layouts, so that a train state of the JAX package
and one of the port compute the same next step.

`save_npz`/`load_npz` store the JAX-layout tree flattened under "/"-joined
keys; that is the weight format nfdpm_tpu_torch/serve.py reads.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import resolve_device

Tree = Any


def tree_to_device(tree: Tree, device: torch.device) -> Tree:
    """numpy leaves -> fp32 tensors on `device`, always copies (training
    updates them in place); 4-D conv weights are kept in channels-last
    memory. Dicts, lists and None pass through."""
    if isinstance(tree, dict):
        return {k: tree_to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_device(v, device) for v in tree]
    if tree is None:
        return None
    t = torch.from_numpy(np.array(tree, np.float32)).to(device)
    return t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t


def _map_w(tree: Tree, fn) -> Tree:
    """Apply `fn` to every conv weight leaf (key "w")."""
    if isinstance(tree, dict):
        return {k: (fn(v) if k == "w" else _map_w(v, fn)) for k, v in tree.items()}
    return tree


def _map_leaves(tree: Tree, fn) -> Tree:
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(v, fn) for v in tree]
    return None if tree is None else fn(tree)


def _first_leaf(tree: Tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _unstack(stacked: Tree) -> list:
    k = np.asarray(_first_leaf(stacked)).shape[0]
    return [_map_leaves(stacked, lambda a, i=i: np.asarray(a)[i]) for i in range(k)]


def _stack(steps: list) -> Tree:
    if isinstance(steps[0], dict):
        return {k: _stack([s[k] for s in steps]) for k in steps[0]}
    return np.stack(steps)


def _hwio_to_oihw(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w, np.float32).transpose(3, 2, 0, 1))


def _oihw_to_hwio(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w, np.float32).transpose(2, 3, 1, 0))


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().contiguous().numpy()
    return np.asarray(t)


def _steps_from_jax(stacked: Tree) -> list:
    return [_map_w(s, _hwio_to_oihw) for s in _unstack(stacked)]


def from_jax_params(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """JAX-layout {"flow", "prior"} tree of numpy arrays -> the port's tree of
    tensors on `device` (the CUDA device unless named)."""
    flow = tree["flow"]
    blocks = []
    for block in flow["blocks"]:
        conv = (block.get("split") or {}).get("conv")
        blocks.append({"steps": _steps_from_jax(block["steps"]),
                       "split": {"conv": None if conv is None
                                 else _map_w(conv, _hwio_to_oihw)}})
    params = {"flow": {"blocks": blocks,
                       "final_steps": _steps_from_jax(flow["final_steps"])},
              "prior": dict(tree.get("prior") or {})}
    return tree_to_device(params, resolve_device(device))


def to_jax_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's {"flow", "prior"} tree -> the JAX layout, numpy on the host."""
    host = _map_leaves(params, _to_numpy)

    def steps_to_jax(steps):
        return _stack([_map_w(s, _oihw_to_hwio) for s in steps])

    flow = host["flow"]
    blocks = []
    for block in flow["blocks"]:
        conv = block["split"]["conv"]
        blocks.append({"steps": steps_to_jax(block["steps"]),
                       "split": {"conv": None if conv is None
                                 else _map_w(conv, _oihw_to_hwio)}})
    return {"flow": {"blocks": tuple(blocks),
                     "final_steps": steps_to_jax(flow["final_steps"])},
            "prior": dict(host.get("prior") or {})}


# Leaves of a PLU 1x1 conv that are constants, not parameters
# (nfdpm_tpu/training/optim.py:FROZEN_LEAF_NAMES).
FROZEN_LEAF_NAMES = ("p_mat", "sign")


def named_leaves(tree: Tree, prefix: str = "", keep_none: bool = False):
    """(path, leaf) for every leaf, paths joined by "/", in the tree's own
    order (dict insertion order, list index). None leaves are left out
    unless `keep_none`, which lets two trees of one structure be walked side
    by side when one of them has None where the other has a tensor. A module
    (a UNet) stands for its named parameters, so it walks like the dict of
    them by name."""
    if isinstance(tree, torch.nn.Module):
        items = tree.named_parameters()
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        if tree is not None or keep_none:
            yield prefix, tree
        return
    for k, v in items:
        yield from named_leaves(v, f"{prefix}/{k}" if prefix else str(k), keep_none)


def map_tree(tree: Tree, fn) -> Tree:
    """`fn` on every tensor of a tree of dicts and lists; a module (a UNet)
    stands for the dict of its parameters by name. None and other leaves (a
    step count) pass through as they are."""
    if isinstance(tree, torch.nn.Module):
        return {k: fn(v) for k, v in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(v, fn) for v in tree]
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def is_frozen_path(path: str) -> bool:
    return path.rsplit("/", 1)[-1] in FROZEN_LEAF_NAMES


def trainable(params: Tree, _name: str = "") -> Tree:
    """A tree over the same storage whose leaves are autograd leaves: every
    one requires grad except the PLU constants p_mat and sign."""
    if isinstance(params, dict):
        return {k: trainable(v, k) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [trainable(v, _name) for v in params]
    if params is None:
        return None
    return params.detach().requires_grad_(_name not in FROZEN_LEAF_NAMES)


def opt_state_from_jax(mu: Dict[str, Any], nu: Dict[str, Any], count: int,
                       device=None, dp=None) -> Dict[str, Any]:
    """Adam's moments as JAX-layout {"flow", "prior"} trees of numpy arrays
    (the `mu` and `nu` of optax's ScaleByAdamState, with zeros where optax
    masks a leaf out) and its step count -> the state of
    training/optim.py:Optimizer.

    With `dp` (models/diffusion_prior.DiffusionPrior) the trees are a
    stage-2 train state's {"flow", "diffusion": {"parts": (flax UNet
    tree, ...)}} (zeros for a group that optax.set_to_zero leaves without
    moments); each part's moments become a dict by the UNet's parameter
    names, in the order the optimizer walks them."""
    if dp is None:
        return {"mu": from_jax_params(mu, device), "nu": from_jax_params(nu, device),
                "count": int(count)}
    device = resolve_device(device)

    def moments(tree):
        params = diffusion_from_jax_params(tree, dp, device)
        return {"flow": params["flow"],
                "diffusion": map_tree(params["diffusion"], torch.Tensor.detach)}

    return {"mu": moments(mu), "nu": moments(nu), "count": int(count)}


def opt_state_to_jax(opt_state: Dict[str, Any], dp=None):
    """The inverse: (mu, nu, count) with the moments in the JAX layout."""
    if dp is None:
        return (to_jax_params(opt_state["mu"]), to_jax_params(opt_state["nu"]),
                int(opt_state["count"]))

    def moments(tree):
        unets = dp.unets_from_named(tree["diffusion"]["parts"], "cpu")
        return diffusion_to_jax_params({"flow": tree["flow"], "diffusion": {"parts": unets}})

    return moments(opt_state["mu"]), moments(opt_state["nu"]), int(opt_state["count"])


def _flatten(tree: Tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif tree is None:
        return
    else:
        out[prefix] = _to_numpy(tree)
        return
    for k, v in items:
        _flatten(v, f"{prefix}/{k}" if prefix else str(k), out)


def _as_sequences(tree: Tree) -> Tree:
    """Dicts whose keys are all decimal indices become tuples."""
    if not isinstance(tree, dict):
        return tree
    tree = {k: _as_sequences(v) for k, v in tree.items()}
    if tree and all(k.isdigit() for k in tree):
        return tuple(tree[k] for k in sorted(tree, key=int))
    return tree


def save_npz(path, tree: Dict[str, Any]) -> None:
    """Write a JAX-layout tree as one .npz, keys joined by "/". None leaves
    (a split without a learned prior) and empty dicts are left out; the
    loader reads their absence back as None and {}."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    np.savez(path, **flat)


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{"a/b/c": leaf} -> {"a": {"b": {"c": leaf}}}."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        node = root
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return root


def load_npz(path) -> Dict[str, Any]:
    """Read a tree written by `save_npz` (numpy leaves, tuples for indices)."""
    with np.load(path) as data:
        return _as_sequences(_unflatten({key: data[key] for key in data.files}))


# ---------------------------------------------------------------------------
# UNet: flax parameter tree <-> models/unet.py modules
# ---------------------------------------------------------------------------

def _unet_layout(unet) -> Dict[str, tuple]:
    """`unet_layout` of the structure of `unet` (models/unet.py)."""
    blocks = {"mid_res1": unet.mid_res1, "mid_res2": unet.mid_res2, "final_res": unet.final_res}
    for side, levels in (("down", unet.downs), ("up", unet.ups)):
        for i, level in enumerate(levels):
            for r in ("res1", "res2"):
                blocks[f"{side}_{i}_{r}"] = level[r]
    return unet_layout(len(unet.downs), {k for k, b in blocks.items() if b.res_conv is not None},
                       hasattr(unet.time_pos, "weights"))


def unet_layout(n_levels: int, res_convs, learned_time: bool) -> Dict[str, tuple]:
    """flax path -> (the port's parameter name, kind) for every leaf of the
    JAX package's Unet (nfdpm_tpu/models/unet.py) of `n_levels` levels whose
    residual blocks named (by flax name: "down_0_res1", "mid_res1",
    "final_res", ...) in `res_convs` have a 1x1 residual conv, with a learned
    or random Fourier time embedding when `learned_time`.

    flax names submodules by class and call order within the scope that
    calls them. `PreNormResidual(LinearAttention(...))` is built in the Unet
    scope, so the attention's parameters sit beside the pre-norm, not under
    it: PreNormResidual_k counts every pre-normed block (the mid attention
    too), LinearAttention_j only the linear ones. The Unet's own convs are
    Conv_0 (init), then the last down level's and the last up level's 3x3,
    then the final 1x1. Kinds: "conv" HWIO <-> OIHW, "dense" [in, out] <->
    [out, in], "mat" (1, 1, in, out) <-> [in, out], "vec" as is."""
    layout: Dict[str, tuple] = {}
    convs = iter(range(4))

    def conv(flax, name):
        layout[f"{flax}/kernel"] = (f"{name}.weight", "conv")
        layout[f"{flax}/bias"] = (f"{name}.bias", "vec")

    def dense(flax, name):
        layout[f"{flax}/kernel"] = (f"{name}.weight", "dense")
        layout[f"{flax}/bias"] = (f"{name}.bias", "vec")

    def res(flax, name):
        dense(f"{flax}/Dense_0", f"{name}.time_dense")
        for j in (0, 1):
            conv(f"{flax}/Block_{j}/WeightStandardizedConv_0", f"{name}.block{j}.conv")
            layout[f"{flax}/Block_{j}/GroupNorm_0/scale"] = (f"{name}.block{j}.norm.weight", "vec")
            layout[f"{flax}/Block_{j}/GroupNorm_0/bias"] = (f"{name}.block{j}.norm.bias", "vec")
        if flax in res_convs:
            conv(f"{flax}/Conv_0", f"{name}.res_conv")

    def attention(flax, name, linear):
        layout[f"{flax}/Conv_0/kernel"] = (f"{name}.w_qkv", "mat")
        layout[f"{flax}/Conv_1/kernel"] = (f"{name}.w_out", "mat")
        layout[f"{flax}/Conv_1/bias"] = (f"{name}.b_out", "vec")
        if linear:
            layout[f"{flax}/ChannelLayerNorm_0/g"] = (f"{name}.g", "vec")

    prenorms, linears = iter(range(2 * n_levels + 1)), iter(range(2 * n_levels))

    def prenorm_attention(name, linear):
        layout[f"PreNormResidual_{next(prenorms)}/ChannelLayerNorm_0/g"] = (f"{name}.norm.g", "vec")
        attention(f"LinearAttention_{next(linears)}" if linear else "Attention_0",
                  f"{name}.fn", linear)

    conv(f"Conv_{next(convs)}", "init_conv")
    if learned_time:
        layout["RandomOrLearnedSinusoidalPosEmb_0/weights"] = ("time_pos.weights", "vec")
    dense("Dense_0", "time_dense0")
    dense("Dense_1", "time_dense1")
    for side in ("down", "up"):
        for i in range(n_levels):
            if side == "up" and i == 0:  # the middle comes between the two paths
                res("mid_res1", "mid_res1")
                prenorm_attention("mid_attn", linear=False)
                res("mid_res2", "mid_res2")
            for r in ("res1", "res2"):
                res(f"{side}_{i}_{r}", f"{side}s.{i}.{r}")
            prenorm_attention(f"{side}s.{i}.attn", linear=True)
            if i == n_levels - 1:
                conv(f"Conv_{next(convs)}", f"{side}s.{i}.{side}")
            else:
                sampler = "Downsample" if side == "down" else "Upsample"
                conv(f"{sampler}_{i}/Conv_0", f"{side}s.{i}.{side}.conv")
    res("final_res", "final_res")
    conv(f"Conv_{next(convs)}", "final_conv")
    return layout


def _leaf_from_flax(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return _hwio_to_oihw(a)
    if kind == "dense":
        return np.ascontiguousarray(a.T)
    if kind == "mat":
        return np.ascontiguousarray(a.reshape(a.shape[-2], a.shape[-1]))
    return a


def _leaf_to_flax(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return _oihw_to_hwio(a)
    if kind == "dense":
        return np.ascontiguousarray(a.T)
    if kind == "mat":
        return a.reshape(1, 1, *a.shape)
    return a


def unet_from_flax(unet, tree: Dict[str, Any]):
    """Fill `unet` (models/unet.py) from a flax Unet parameter tree, in
    place. Strict: raises KeyError when the tree has a leaf the module
    structure does not, or lacks one it has, and ValueError on a shape
    mismatch; every module parameter is assigned. Returns `unet`."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    layout = _unet_layout(unet)
    params = dict(unet.named_parameters())
    extra, missing = sorted(set(flat) - set(layout)), sorted(set(layout) - set(flat))
    if extra or missing:
        raise KeyError(f"flax UNet tree does not match the module: extra leaves "
                       f"{extra}, missing leaves {missing}")
    unassigned = sorted(set(params) - {name for name, _ in layout.values()})
    if unassigned:
        raise KeyError(f"module parameters with no flax leaf: {unassigned}")
    with torch.no_grad():
        for path, (name, kind) in layout.items():
            a = _leaf_from_flax(flat[path], kind)
            p = params[name]
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{path} {tuple(a.shape)} does not fit {name} "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.asarray(a, np.float32)))
    return unet


def unet_to_flax(unet) -> Dict[str, Any]:
    """The module's parameters as the flax Unet tree (numpy, host)."""
    params = dict(unet.named_parameters())
    return _unflatten({path: _leaf_to_flax(_to_numpy(params[name]), kind)
                       for path, (name, kind) in _unet_layout(unet).items()})


def diffusion_from_jax_params(tree: Dict[str, Any], dp, device=None,
                              requires_grad: bool = False) -> Dict[str, Any]:
    """A stage-2 tree {"flow" (optional), "prior" (optional), "diffusion":
    {"parts": (p_0, ...)}} of numpy arrays -> {"flow", "prior", "diffusion":
    {"parts": [Unet, ...]}} on `device` (CUDA unless named); `dp` is the
    models/diffusion_prior.DiffusionPrior the UNets belong to. Without a
    "flow" (an EMA shadow of the UNets alone) only "diffusion" comes back.
    `requires_grad=True` makes every parameter but p_mat and sign an
    autograd leaf (a train state's)."""
    device = resolve_device(device)
    parts = tree["diffusion"]["parts"]
    if len(parts) != dp.num_parts:
        raise ValueError(f"{len(parts)} UNet trees for a prior of {dp.num_parts} parts")
    unets = [dp.place(unet_from_flax(dp.build_unet(i), p), device, requires_grad)
             for i, p in enumerate(parts)]
    params = {}
    if "flow" in tree:
        params = from_jax_params({"flow": tree["flow"], "prior": tree.get("prior")}, device)
        if requires_grad:
            params = trainable(params)
    params["diffusion"] = {"parts": unets}
    return params


def params_for_rank(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """A whole parameter tree in the port's layout ({"flow", "prior"} or
    {"flow", "diffusion": {"parts": [Unet, ...]}}: from_jax_params or
    diffusion_from_jax_params of the JAX package's arrays, or a
    checkpoint's restore_params) -> this rank's slabs on the model axis of
    `mesh` (parallel/mesh.py): the coupling CNNs' leaves by the Glow rules,
    each UNet narrowed in place by the UNet rules
    (parallel/sharding_rules.py); under spatial partitioning the UNets'
    slabs only (the flow stays whole). Without a model axis, the tree
    itself."""
    from .parallel import tensor_parallel as tp
    from .parallel.sharding_rules import model_placements

    if mesh is None or mesh.n_model == 1:
        return params
    return tp.shard_tree(mesh.model, params, model_placements(mesh, params))


def diffusion_to_jax_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of `diffusion_from_jax_params`: numpy, JAX layout, ready
    for `save_npz`."""
    tree = to_jax_params(params)
    tree["diffusion"] = {"parts": tuple(unet_to_flax(u) for u in params["diffusion"]["parts"])}
    return tree


# ---------------------------------------------------------------------------
# Feature nets of the metrics: flax parameter trees -> state dicts
# ---------------------------------------------------------------------------

_BN_LEAVES = {"bn_gamma": "weight", "bn_beta": "bias", "bn_mean": "running_mean",
              "bn_var": "running_var"}


def _state_dict(named: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in named.items()}


def inception_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's Inception-v3 tree (nfdpm_tpu/metrics/inception.py)
    as a state dict of metrics/inception.FIDInceptionV3: conv kernels HWIO
    -> OIHW, bn_{gamma,beta,mean,var} -> bn.{weight,bias,running_mean,
    running_var}, and a zero step counter per batch norm; the inverse of
    the JAX package's `import_state_dict`. Raises KeyError on a leaf it
    cannot place."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    named, counters = {}, {}
    for path, a in flat.items():
        scope, _, leaf = path.rpartition("/")
        module = scope.replace("/", ".")
        if leaf == "kernel" and scope.endswith("/conv"):
            named[f"{module}.weight"] = _hwio_to_oihw(a)
        elif leaf in _BN_LEAVES:
            named[f"{module}.bn.{_BN_LEAVES[leaf]}"] = a
            counters[f"{module}.bn.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
        else:
            raise KeyError(f"no Inception parameter for the flax leaf {path}")
    return {**_state_dict(named), **counters}


_CLIP_DENSE = {"attn/in_proj": "attn.in_proj_", "attn/out_proj": "attn.out_proj.",
               "mlp_fc": "mlp.c_fc.", "mlp_proj": "mlp.c_proj."}


def clip_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's CLIP visual tree (nfdpm_tpu/metrics/clip_features.py)
    as a state dict of metrics/clip_features.VisionTransformer (OpenAI's
    `visual.*` names without the prefix): block_i -> transformer.resblocks.i,
    dense kernels [in, out] -> weights [out, in], the patch conv HWIO ->
    OIHW, LayerNorm scale -> weight. Raises KeyError on a leaf it cannot
    place."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    named = {}
    for path, a in flat.items():
        scope, _, leaf = path.rpartition("/")
        prefix = ""
        if scope.startswith("block_"):
            block, _, scope = scope.partition("/")
            prefix = f"transformer.resblocks.{block[len('block_'):]}."
        if scope == "conv1" and leaf == "kernel":
            name, a = "conv1.weight", _hwio_to_oihw(a)
        elif scope == "" and leaf in ("class_embedding", "positional_embedding", "proj"):
            name = leaf
        elif scope in ("ln_pre", "ln_post", "ln_1", "ln_2") and leaf in ("scale", "bias"):
            name = f"{scope}.{'weight' if leaf == 'scale' else 'bias'}"
        elif scope in _CLIP_DENSE and leaf in ("kernel", "bias"):
            name = _CLIP_DENSE[scope] + ("weight" if leaf == "kernel" else "bias")
            a = np.ascontiguousarray(a.T) if leaf == "kernel" else a
        else:
            raise KeyError(f"no CLIP parameter for the flax leaf {path}")
        named[prefix + name] = a
    return _state_dict(named)
