"""Plain stage-1 training steps: the reference the benchmark holds the Glow
train step against.

One step: bits/dim of the batch (5-bit codes plus the U(0, 1/32)
dequantization draw, the Glow log-likelihood of perfbench/reference/glow.py),
its gradient by autograd, every element clipped to [-1, 1], then the whole
gradient scaled to global norm 1 where it is larger, then Adam (b1 0.9, b2
0.999, eps 1e-8, bias-corrected, the step rate m_hat / (sqrt(v_hat) + eps),
the rate after a linear warmup from 0 where the configuration has one).
The trained leaves are the flow's, except the permutation and the signs of
the 1x1 convolutions' factors (fixed by construction); the top prior stays
at its initial value, as the reference repository's trainer keeps it.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from . import glow

FIXED = ("p_mat", "sign")


def leaves(tree, prefix: str = ""):
    """(path, tensor) of every leaf, paths joined by "/"."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}" if prefix else str(i))
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def trained(path: str) -> bool:
    return path.startswith("flow/") and path.rsplit("/", 1)[-1] not in FIXED


def train_steps(params, batches: Sequence[torch.Tensor], noises: Sequence[torch.Tensor],
                n_bits: int, lr: float, warmup: int = 0, dtype=torch.float32) -> Dict[str, object]:
    """Run len(batches) steps from `params` ({"flow", "prior"}, not changed).

    batches[i]: images in [0, 1] [B, H, W, C]; noises[i]: the U(0, 1)
    dequantization draw of step i. Update k (from 1) takes the rate
    lr min(k - 1, warmup) / warmup (a linear warmup from 0), lr without one. Returns {"bpd": [per step],
    "grad1": {path: step 1's gradient as Adam takes it, after both clips},
    "params": {path: the trained leaves after the last step}}."""
    p = glow.cast(params, dtype)
    named = {path: t.detach().clone() for path, t in leaves(p)}
    train = [path for path in named if trained(path)]
    for path in train:
        named[path].requires_grad_(True)
    tree = _rebuild(p, named)
    m = {path: torch.zeros_like(named[path]) for path in train}
    v = {path: torch.zeros_like(named[path]) for path in train}
    out = {"bpd": [], "grad1": None, "params": None}
    b1, b2, eps = 0.9, 0.999, 1e-8
    for step, (batch, noise) in enumerate(zip(batches, noises), start=1):
        x = glow.preprocess(batch.to(dtype), n_bits) + noise.to(dtype) / 2.0 ** n_bits
        ll = glow.forward({**tree["flow"], "prior": tree["prior"]}, x)
        bpd = glow.bits_per_dim(ll, n_bits, x[0].numel())
        grads = torch.autograd.grad(bpd, [named[path] for path in train])
        with torch.no_grad():
            grads = [g.clamp(-1.0, 1.0) for g in grads]
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            if norm >= 1.0:
                grads = [g / norm for g in grads]
            rate = lr * min(step - 1, warmup) / warmup if warmup else lr
            if step == 1:
                out["grad1"] = {path: g.clone() for path, g in zip(train, grads)}
            for path, g in zip(train, grads):
                m[path].mul_(b1).add_(g, alpha=1 - b1)
                v[path].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m[path] / (1 - b1 ** step)
                v_hat = v[path] / (1 - b2 ** step)
                named[path].sub_(rate * m_hat / (torch.sqrt(v_hat) + eps))
        out["bpd"].append(float(bpd.detach()))
    out["params"] = {path: named[path].detach() for path in train}
    return out


def _rebuild(tree, named: Dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, named, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, named, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return named[prefix] if isinstance(tree, torch.Tensor) else tree


def norm_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
             skip: Sequence[str] = ()) -> Dict[str, object]:
    """The worst leaf's gap of norms: |‖a‖ - ‖b‖| over the larger of the
    reference's norm of that leaf and the median leaf's, over the leaves
    not in `skip`. Returns {"value", "leaf"}."""
    norms = {k: float(torch.linalg.vector_norm(reference[k].double())) for k in reference}
    kept = sorted(v for k, v in norms.items() if k not in skip)
    median = kept[len(kept) // 2] if kept else 0.0
    worst, leaf = 0.0, None
    for k, ref in norms.items():
        if k in skip:
            continue
        a = float(torch.linalg.vector_norm(program[k].double()))
        gap = abs(a - ref) / max(ref, median, 1e-30)
        if not math.isfinite(gap):
            return {"value": math.inf, "leaf": k}
        if gap > worst or leaf is None:
            worst, leaf = gap, k
    return {"value": worst, "leaf": leaf}
