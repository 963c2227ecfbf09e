"""Partition rules for the parameters and the Adam moments.

Counterpart of nfdpm_tpu/parallel/sharding_rules.py. The rules are pure
functions of leaf names and shapes, ported whole: a spec is a plain tuple
in place of jax's PartitionSpec, one entry an axis, "model", "data" or None,
trailing Nones left out as PartitionSpec leaves them.

  * `_spec_for` / `_unet_spec_for`: the Megatron-style "model" entries of
    the coupling CNN and the UNet;
  * `_add_fsdp`: the ZeRO "data" entry on the largest still-unsharded axis
    that divides, for leaves of at least FSDP_MIN_SIZE elements;
  * `glow_param_specs`, `unet_param_specs`, `generic_param_specs` over a
    tree in the JAX package's layout: the Glow's K-stacked steps with HWIO
    conv kernels (`glow_jax_shapes` gives it for the port's tree), a flax
    UNet tree (`unet_jax_shapes`, through convert.py's name table).

`placements` map the specs back onto the port's own leaves.

The "model" entries (`glow_model_placements`, `unet_model_placements`):
`Placement(dim=...)` over n_model, rank m holding slab m of that axis of
the port's leaf (OIHW kernels, the K steps as separate leaves, the
attention's [in, out] matrices). Under a model axis the rank's parameters
ARE these slabs (parallel/tensor_parallel.py, ops/coupling.py,
models/unet.py).

The "data" entries (ZeRO stage 3, `parallel.fsdp`): a "data" entry on an
axis of the leaf becomes a `Placement(dim=...)`: data rank r keeps slab r
of that axis of what the rank holds (the leaf, or its model slab: the spec
is computed on the whole leaf's shape with its "model" entry, as the JAX
spec composes them). A "data" entry on the K axis of a stacked step leaf,
which the port keeps as K separate leaves, becomes `Placement(owner=r)`:
step k's leaf lies whole with rank k // (K / n) and empty elsewhere. A
placement partitions the parameter, its Adam moments and its EMA shadow
alike; the units of the model gather the slabs on use (parallel/zero.py).
The pipeline's stages (parallel/pipeline.py) are owner placements over the
model axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..convert import _unet_layout, named_leaves

# FSDP leaves smaller than this many elements stay replicated: all-gathering
# a few-KB actnorm vector costs more latency than the memory it saves.
FSDP_MIN_SIZE = 2 ** 15



class Spec(tuple):
    """A partition spec: one entry an axis (as jax's PartitionSpec, also a
    tuple); a leaf of a specs tree, not a sequence of leaves."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class Shape:
    """A leaf of a shapes-only tree."""
    shape: Tuple[int, ...]


def _add_fsdp(spec: Spec, shape, n_data: int, min_size: int = FSDP_MIN_SIZE) -> Spec:
    """Augment a (possibly tensor-parallel) spec with a ZeRO-style "data"
    shard on the largest still-unsharded, divisible dimension. Leaves with
    no divisible axis, or smaller than `min_size` elements, stay as they
    are (replicated)."""
    size = 1
    for d in shape:
        size *= d
    if n_data <= 1 or size < min_size:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best = None
    for i, d in enumerate(shape):
        if entries[i] is not None:
            continue
        if d % n_data == 0 and (best is None or d > shape[best]):
            best = i
    if best is None:
        return spec
    entries[best] = "data"
    while entries and entries[-1] is None:
        entries.pop()
    return Spec(*entries)


def _flatten_with_names(tree, names=()):
    """(names of the path, leaf) for every non-None leaf, in order: a dict
    key is its name, a sequence index the empty name (as jax's
    tree_flatten_with_path gives them to the rules)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten_with_names(v, names + (str(k),))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        for v in tree:
            yield from _flatten_with_names(v, names + ("",))
    elif tree is not None:
        yield names, tree


def _map_with_names(tree, fn, names=()):
    if isinstance(tree, dict):
        return {k: _map_with_names(v, fn, names + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_names(v, fn, names + ("",)) for v in tree)
    return None if tree is None else fn(names, tree)


def _spec_for(names) -> Spec:
    stacked = "steps" in names or "final_steps" in names
    pre = (None,) if stacked else ()

    def spec(*axes):
        return Spec(*pre, *axes)

    if "conv1" in names and names[-1] == "w":
        return spec(None, None, None, "model")
    if names[-1] in ("scale", "bias") and "an1" in names:
        return spec("model")
    if "conv2" in names and names[-1] == "w":
        return spec(None, None, "model", None)
    if "zconv" in names and names[-1] == "w" and "net" in names:
        return spec(None, None, "model", None)
    return Spec()


def glow_param_specs(params: Any, *, fsdp_data: int = 1,
                     fsdp_min_size: int = FSDP_MIN_SIZE) -> Any:
    """Specs of a Glow parameter tree in the JAX layout (K-stacked steps,
    HWIO kernels; `glow_jax_shapes`). With `fsdp_data` > 1 every spec also
    shards its largest free axis over "data"."""
    return _map_with_names(params, lambda names, leaf: _add_fsdp(
        _spec_for(names), tuple(leaf.shape), fsdp_data, fsdp_min_size))


def _unet_spec_for(names) -> Spec:
    """Megatron-style TP for the UNet's ResnetBlocks and attention (the JAX
    package's rules, over flax's names)."""
    joined = "/".join(names)

    def inblock(block_name):
        return any(n == block_name for n in names)

    if inblock("Block_0") and names[-1] == "kernel":
        return Spec(None, None, None, "model")
    if inblock("Block_0") and names[-1] == "bias":
        return Spec("model")
    if inblock("Block_0") and ("GroupNorm_0" in joined) and names[-1] in ("scale", "bias"):
        return Spec("model")
    if inblock("Block_1") and names[-1] == "kernel" and "WeightStandardizedConv_0" in joined:
        return Spec(None, None, "model", None)
    if "LinearAttention_0" in names or "Attention_0" in names:
        if names[-1] == "kernel" and "Conv_0" in names:
            return Spec(None, None, None, "model")
        if names[-1] == "kernel" and "Conv_1" in names:
            return Spec(None, None, "model", None)
    return Spec()


def unet_param_specs(params: Any, *, fsdp_data: int = 1,
                     fsdp_min_size: int = FSDP_MIN_SIZE) -> Any:
    """Specs of a flax UNet parameter tree (`unet_jax_shapes`)."""
    return _map_with_names(params, lambda names, leaf: _add_fsdp(
        _unet_spec_for(names), tuple(leaf.shape), fsdp_data, fsdp_min_size))


def generic_param_specs(params: Any, *, fsdp_data: int = 1,
                        fsdp_min_size: int = FSDP_MIN_SIZE) -> Any:
    """Replicated-by-default specs with optional data-axis FSDP, for trees
    with no tensor-parallel rules (the Gaussian prior)."""
    return _map_with_names(params, lambda names, leaf: _add_fsdp(
        Spec(), tuple(leaf.shape), fsdp_data, fsdp_min_size))


# -- the JAX layout of the port's trees, shapes only -------------------------

# an HWIO axis -> the OIHW axis that holds it
_HWIO_TO_OIHW = {0: 2, 1: 3, 2: 1, 3: 0}
# flax layout -> the port's, per kind of convert.unet_layout
_UNET_AXES = {"conv": _HWIO_TO_OIHW, "dense": {0: 1, 1: 0}, "mat": {2: 0, 3: 1}}


def _jax_shape(name: str, shape) -> Tuple[int, ...]:
    s = tuple(shape)
    return (s[2], s[3], s[1], s[0]) if name == "w" and len(s) == 4 else s


def _stack_shapes(steps: list) -> Any:
    def walk(nodes, name=""):
        if isinstance(nodes[0], dict):
            return {k: walk([n[k] for n in nodes], k) for k in nodes[0]}
        return Shape((len(nodes),) + _jax_shape(name, nodes[0].shape))

    return walk(steps)


def glow_jax_shapes(flow: Any) -> Any:
    """The port's flow tree -> the JAX package's layout, shapes only."""
    def unstacked(tree, name=""):
        if isinstance(tree, dict):
            return {k: unstacked(v, k) for k, v in tree.items()}
        return None if tree is None else Shape(_jax_shape(name, tree.shape))

    return {"blocks": tuple({"steps": _stack_shapes(b["steps"]),
                             "split": {"conv": unstacked(b["split"]["conv"])}}
                            for b in flow["blocks"]),
            "final_steps": _stack_shapes(flow["final_steps"])}


def unet_jax_shapes(unet) -> Dict[str, Any]:
    """A UNet module -> its flax parameter tree (convert.py's name table),
    shapes only, nested by flax path."""
    params = dict(unet.named_parameters())
    root: Dict[str, Any] = {}
    for path, (name, kind) in _unet_layout(unet).items():
        s = tuple(params[name].shape)
        shape = {"conv": lambda: (s[2], s[3], s[1], s[0]), "dense": lambda: (s[1], s[0]),
                 "mat": lambda: (1, 1) + s}.get(kind, lambda: s)()
        node = root
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = Shape(shape)
    return root


# -- placements on the port's leaves -----------------------------------------

@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a leaf lives over an axis of `n` ranks: slab `rank` of axis
    `dim` on each rank, or (dim None) the whole leaf on rank `owner`."""
    n: int
    dim: Optional[int] = None
    owner: Optional[int] = None

    def slab(self, t: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank `rank`'s part of `t` (a view; empty where it owns none)."""
        if self.dim is None:
            return t if rank == self.owner else t.narrow(0, 0, 0)
        if t.shape[self.dim] % self.n:
            raise ValueError(f"axis {self.dim} of a {tuple(t.shape)} leaf does not split "
                             f"into {self.n} slabs")
        per = t.shape[self.dim] // self.n
        return t.narrow(self.dim, rank * per, per)


def _data_axis(spec: Spec) -> Optional[int]:
    return spec.index("data") if "data" in spec else None


def _leaf_at(tree, names):
    for name in names:
        tree = tree[name]
    return tree


def _axis_of(names, leaf: torch.Tensor, jax_axis: int) -> int:
    """The port's axis of a Glow leaf that holds JAX axis `jax_axis` (of the
    unstacked leaf): conv kernels are OIHW in the port, HWIO in JAX."""
    if names[-1] == "w" and len(leaf.shape) == 4:
        return _HWIO_TO_OIHW[jax_axis]
    return jax_axis


def _glow_placements(flow, specs, n: int, prefix: str) -> Dict[str, Placement]:
    out: Dict[str, Placement] = {}

    def stacked(steps, spec_tree, path):
        k = len(steps)
        for names, spec in _flatten_with_names(spec_tree):
            d = _data_axis(spec)
            if d is None:
                continue
            for i, step in enumerate(steps):
                out[f"{path}/{i}/{'/'.join(names)}"] = (
                    Placement(n, owner=i // (k // n)) if d == 0 else
                    Placement(n, dim=_axis_of(names, _leaf_at(step, names), d - 1)))

    for b, (block, bspec) in enumerate(zip(flow["blocks"], specs["blocks"])):
        stacked(block["steps"], bspec["steps"], f"{prefix}/blocks/{b}/steps")
        conv = block["split"]["conv"]
        for names, spec in _flatten_with_names(bspec["split"]["conv"]):
            d = _data_axis(spec)
            if d is not None:
                out[f"{prefix}/blocks/{b}/split/conv/{'/'.join(names)}"] = Placement(
                    n, dim=_axis_of(names, _leaf_at(conv, names), d))
    stacked(flow["final_steps"], specs["final_steps"], f"{prefix}/final_steps")
    return out


def _whole_shapes(shapes, spec_for, n_model: int):
    """A shapes tree of a rank's model slabs -> the whole leaves' shapes:
    the axis each leaf's "model" entry names times n_model."""
    def whole(names, leaf):
        spec = spec_for(names)
        if n_model == 1 or "model" not in spec:
            return leaf
        s = list(leaf.shape)
        s[spec.index("model")] *= n_model
        return Shape(tuple(s))

    return _map_with_names(shapes, whole)


def glow_placements(flow, n_data: int, prefix: str = "flow",
                    fsdp_min_size: Optional[int] = None,
                    n_model: int = 1) -> Dict[str, Placement]:
    """Placements of the flow's leaves ("<prefix>/..." paths of
    convert.named_leaves) under ZeRO over `n_data` ranks; a leaf that is
    not named stays replicated. `fsdp_min_size` defaults to the module's
    FSDP_MIN_SIZE at call time (tests lower it to shard small models).
    With `n_model` > 1, `flow` holds a rank's model slabs."""
    fsdp_min_size = FSDP_MIN_SIZE if fsdp_min_size is None else fsdp_min_size
    shapes = _whole_shapes(glow_jax_shapes(flow), _spec_for, n_model)
    specs = glow_param_specs(shapes, fsdp_data=n_data, fsdp_min_size=fsdp_min_size)
    return _glow_placements(flow, specs, n_data, prefix)


def unet_placements(unet, n_data: int, prefix: str,
                    fsdp_min_size: Optional[int] = None,
                    n_model: int = 1) -> Dict[str, Placement]:
    """Placements of a UNet module's parameters ("<prefix>/<name>"); with
    `n_model` > 1 the module holds a rank's model slabs."""
    fsdp_min_size = FSDP_MIN_SIZE if fsdp_min_size is None else fsdp_min_size
    shapes = _whole_shapes(unet_jax_shapes(unet), _unet_spec_for, n_model)
    specs = dict(_flatten_with_names(unet_param_specs(shapes, fsdp_data=n_data,
                                                      fsdp_min_size=fsdp_min_size)))
    out: Dict[str, Placement] = {}
    for path, (name, kind) in _unet_layout(unet).items():
        d = _data_axis(specs[tuple(path.split("/"))])
        if d is not None:
            out[f"{prefix}/{name}"] = Placement(n_data, dim=_UNET_AXES.get(kind, {}).get(d, d))
    return out


def _model_dim(spec: Spec) -> Optional[int]:
    return spec.index("model") if "model" in spec else None


def glow_model_placements(flow, n_model: int, prefix: str = "flow") -> Dict[str, Placement]:
    """The "model" placements of the flow's leaves ({} at one model rank):
    each coupling net's conv1 kernel on its output width, an1's scale and
    bias, conv2's and the net's zeroconv kernel on their input width (the
    JAX package's _spec_for; the split priors' zeroconvs stay whole)."""
    if n_model <= 1:
        return {}
    out: Dict[str, Placement] = {}
    for path, leaf in named_leaves(flow, prefix):
        names = tuple(path.split("/"))
        spec = _spec_for(names)
        if "steps" in names or "final_steps" in names:  # the K axis is not the port's
            spec = Spec(*spec[1:])
        m = _model_dim(spec)
        if m is not None:
            out[path] = Placement(n_model, dim=_axis_of(names, leaf, m))
    return out


def unet_model_placements(unet, n_model: int, prefix: str = "") -> Dict[str, Placement]:
    """The "model" placements of a UNet module's parameters
    ("<prefix>/<name>", or "<name>" without a prefix; {} at one model
    rank): the JAX package's _unet_spec_for over flax's names."""
    if n_model <= 1:
        return {}
    out: Dict[str, Placement] = {}
    for path, (name, kind) in _unet_layout(unet).items():
        m = _model_dim(_unet_spec_for(tuple(path.split("/"))))
        if m is not None:
            key = f"{prefix}/{name}" if prefix else name
            out[key] = Placement(n_model, dim=_UNET_AXES.get(kind, {}).get(m, m))
    return out


def model_placements(mesh, params: Any) -> Dict[str, Placement]:
    """The placements of a parameter tree of either stage ({"flow",
    "prior"} or {"flow", "diffusion": {"parts": [Unet, ...]}}, the port's
    layout) over the model axis of `mesh` (parallel/mesh.Mesh, or anything
    with its n_model and spatial; {} for None or one model rank): the
    flow's by the Glow rules, each UNet's by the UNet rules. Under spatial
    partitioning (mesh.spatial) the model axis carries the flow's image
    rows: the flow holds no slabs."""
    n_model = 1 if mesh is None else mesh.n_model
    if n_model <= 1:
        return {}
    out = {}
    if params.get("flow") is not None and not mesh.spatial:
        out.update(glow_model_placements(params["flow"], n_model, "flow"))
    for i, unet in enumerate((params.get("diffusion") or {}).get("parts", ())):
        out.update(unet_model_placements(unet, n_model, f"diffusion/parts/{i}"))
    return out


def generic_placements(tree, n_data: int, prefix: str,
                       fsdp_min_size: Optional[int] = None) -> Dict[str, Placement]:
    """Placements of a tree with no tensor-parallel rules (same layout in
    both packages: the Gaussian prior)."""
    fsdp_min_size = FSDP_MIN_SIZE if fsdp_min_size is None else fsdp_min_size
    out = {}
    for path, leaf in named_leaves(tree, prefix):
        d = _data_axis(_add_fsdp(Spec(), tuple(leaf.shape), n_data, fsdp_min_size))
        if d is not None:
            out[path] = Placement(n_data, dim=d)
    return out


def replace_leaves(tree: Any, new: Dict[str, torch.Tensor], prefix: str = "") -> Any:
    """`tree` with the leaves at the paths of `new` replaced (a module's
    parameters become a dict by name, as map_tree makes them)."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        return {k: replace_leaves(v, new, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [replace_leaves(v, new, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return new.get(prefix, tree)


def moment_bytes(opt_state: Dict[str, Any]) -> int:
    """Bytes of the Adam moments this rank holds."""
    return sum(t.numel() * t.element_size() for key in ("mu", "nu")
               for _, t in named_leaves(opt_state[key]) if isinstance(t, torch.Tensor))


def _predicted_bytes(params: Any, placements: Dict[str, Placement], rank: int) -> int:
    total = 0
    for path, t in named_leaves(params):
        pl = placements.get(path)
        n = t.numel() if pl is None else pl.slab(t, rank).numel()
        total += n * t.element_size()
    return total


def predicted_moment_bytes(params: Any, placements: Dict[str, Placement], rank: int) -> int:
    """What the placements leave this rank: every leaf's two moments, whole
    or its slab (`params`: what the rank holds, its model slabs under a
    model axis; `placements`, `rank`: the data axis's)."""
    return 2 * _predicted_bytes(params, placements, rank)


def predicted_param_bytes(params: Any, placements: Dict[str, Placement], rank: int) -> int:
    """The parameter bytes a rank holds under `placements` at index `rank`
    of their axis, from the tree `params` as it is before their cut: the
    whole tree and the model placements, or a rank's model slabs (whole
    without a model axis) and the data axis's."""
    return _predicted_bytes(params, placements, rank)


def param_bytes(params: Any) -> int:
    """Bytes of the parameters a rank holds."""
    return sum(t.numel() * t.element_size() for _, t in named_leaves(params))

