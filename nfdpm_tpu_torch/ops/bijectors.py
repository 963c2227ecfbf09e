"""Functional bijector primitives for the Glow flow, NHWC layout.

Counterpart of nfdpm_tpu/ops/bijectors.py. Every bijector is a set of plain
functions over a parameter dict of tensors:

    init_<name>(rng, ...)            -> params (host-side numpy)
    <name>_forward(params, x, ldj)   -> (y, ldj)     # ldj: [B] fp32
    <name>_inverse(params, y)        -> x
    <name>_ddinit(params, x)         -> (new params, y)   # data-dependent init
                                     # (actnorm_ddinit takes x alone)

identity_forward/identity_inverse take no params. The Glow step runs the
actnorm and the 1x1 conv folded into one channel mix
(fused_actnorm_invconv_forward); actnorm_forward then invconv_forward is
the same map, unfused.

Parameter init is host-side numpy from the same generator calls as the JAX
package, so one integer seed gives the same weights in both;
convert.tree_to_device moves a tree onto its device in one pass.

The Glow step has two routes. `step_forward`/`step_inverse` with
`use_kernels=False` are plain PyTorch. `step_forward_kernels` and
`step_inverse_kernels` (the counterparts of step_forward_pallas and
step_inverse_pallas) send the folded actnorm + 1x1-conv channel mix and the
coupling tail through the wrappers in ops/kernels/, which launch the CUDA
kernels for CUDA tensors and take the plain versions for CPU tensors; the
forward's tail also takes in the zeroconv's epilogue, the concatenation of
the halves and the logdet add (coupling_step_tail).
`step_forward_megakernel` runs a whole forward step in one kernel, as the
JAX package's experiment does; no config selects it.

The coupling functions and both step routes take the model axis
(`model`, tensor parallelism of the coupling CNN, ops/coupling.py; None on
one rank) and the coupling CNN's `dtype` (GlowConfig.coupling_dtype: bf16
runs its two inner convolutions in bf16, ops/coupling.py); the
data-dependent init and the megakernel are fp32 whatever it is, as in the
JAX package.

Spatial partitioning (`rows`, the model axis carrying image rows,
parallel/spatial.py) runs the forward of the train step on a rank's row
block: the 3x3 convolutions of the coupling CNN and of the split prior
exchange halo rows, and every logdet and log-density is the partial sum of
the rank's pixels (the channel mix's h*w*ld with the rank's h), which the
trainer sums over the model group once. The squeeze is exact per block
(the guard keeps every block's row count even).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import draws
from .coupling import (actnorm_stats_init, coupling_net_apply, coupling_net_conv,
                       coupling_net_ddinit, init_coupling_net)
from .kernels.channel_mix import channel_mix
from .kernels.coupling_tail import coupling_step_tail, coupling_step_tail_inverse
from .kernels.step_megakernel import step_megakernel_forward
from .zeroconv import init_zeroconv, zeroconv_apply
from ..utils.profiling import annotate

Params = Dict[str, Any]

_EPS_COUPLING = 1e-6
_LOG_2PI = float(np.log(2.0 * np.pi))


def as_host_rng(seed_or_rng) -> np.random.Generator:
    """An int seed becomes the same numpy Generator the JAX package builds
    from it (bijectors.as_host_rng); a Generator passes through."""
    if isinstance(seed_or_rng, np.random.Generator):
        return seed_or_rng
    return np.random.default_rng(np.random.SeedSequence(int(seed_or_rng)))


# ---------------------------------------------------------------------------
# Identity
# ---------------------------------------------------------------------------

def identity_forward(x: torch.Tensor, ldj: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return x, ldj


def identity_inverse(y: torch.Tensor) -> torch.Tensor:
    return y


# ---------------------------------------------------------------------------
# ActNorm
# ---------------------------------------------------------------------------

def init_actnorm(channels: int) -> Params:
    """Zero init (log-scale and bias); a trained or imported model fills them."""
    return {"scale": np.zeros((channels,), np.float32),
            "bias": np.zeros((channels,), np.float32)}


def actnorm_forward(params: Params, x: torch.Tensor,
                    ldj: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """y = exp(scale) * (x + bias); ldj += H*W*sum(scale). x: [B, H, W, C].
    The Glow step runs it folded into the 1x1 conv
    (fused_actnorm_invconv_forward)."""
    h, w = x.shape[1], x.shape[2]
    y = torch.exp(params["scale"]) * (x + params["bias"])
    return y, ldj + (h * w) * torch.sum(params["scale"]).to(ldj.dtype)


def actnorm_inverse(params: Params, y: torch.Tensor) -> torch.Tensor:
    """x = y * exp(-scale) - bias."""
    return y * torch.exp(-params["scale"]) - params["bias"]


@torch.no_grad()
def actnorm_ddinit(x: torch.Tensor) -> Tuple[Params, torch.Tensor]:
    """Data-dependent init from one batch x [B, H, W, C]: new leaves that
    give exp(scale) * (x + bias) zero mean and unit variance per channel,
    and that output."""
    new = actnorm_stats_init(x)
    return new, torch.exp(new["scale"]) * (x + new["bias"])


# ---------------------------------------------------------------------------
# Invertible 1x1 convolution: PLU or full-W
# ---------------------------------------------------------------------------

def plu_from_weight(w) -> Params:
    """Decompose a full invertible [C, C] weight ([out, in]) into the PLU
    leaves p_mat / lower / upper / log_s / sign (host-side scipy)."""
    import scipy.linalg

    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    p, l, u = scipy.linalg.lu(np.asarray(w, np.float64))
    s = np.diag(u).copy()
    return {
        "p_mat": np.asarray(p, np.float32),
        "lower": np.asarray(np.tril(l, -1), np.float32),
        "upper": np.asarray(np.triu(u, 1), np.float32),
        "log_s": np.asarray(np.log(np.abs(s)), np.float32),
        "sign": np.asarray(np.sign(s), np.float32),
    }


def init_invconv(rng, channels: int) -> Params:
    """Random orthogonal weight (QR of a Gaussian), PLU-decomposed."""
    w = np.linalg.qr(as_host_rng(rng).normal(size=(channels, channels)))[0]
    return plu_from_weight(w)


def init_invconv_full(rng, channels: int) -> Params:
    """Random orthogonal weight kept as one full [C, C] matrix."""
    w = np.linalg.qr(as_host_rng(rng).normal(size=(channels, channels)))[0]
    return {"weight": np.asarray(w, np.float32)}


def _plu_factors(params: Params) -> Tuple[torch.Tensor, torch.Tensor]:
    log_s = params["log_s"]
    eye = torch.eye(log_s.shape[0], dtype=torch.float32, device=log_s.device)
    l = eye + torch.tril(params["lower"], -1)
    u = torch.triu(params["upper"], 1) + torch.diag(params["sign"] * torch.exp(log_s))
    return l, u


def invconv_logdet(params: Params) -> torch.Tensor:
    """Per-pixel log|det W|: sum(log_s) for PLU; slogdet for full-W."""
    if "weight" in params:
        return torch.linalg.slogdet(params["weight"])[1]
    return torch.sum(params["log_s"])


def invconv_weight(params: Params) -> torch.Tensor:
    """Full weight W [O, C]: the stored matrix, or P @ L @ U from PLU."""
    if "weight" in params:
        return params["weight"]
    l, u = _plu_factors(params)
    return params["p_mat"] @ (l @ u)


def invconv_forward(params: Params, x: torch.Tensor,
                    ldj: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """y[..., o] = sum_c W[o, c] x[..., c]; ldj += H*W*log|det W|. As the
    JAX package's invconv_weight does, W takes no gradient into the fixed
    PLU factors p_mat and sign."""
    h, w = x.shape[1], x.shape[2]
    fixed = params if "weight" in params else dict(
        params, p_mat=params["p_mat"].detach(), sign=params["sign"].detach())
    y = torch.matmul(x, invconv_weight(fixed).T)
    return y, ldj + (h * w) * invconv_logdet(params).to(ldj.dtype)


def invconv_inverse(params: Params, y: torch.Tensor) -> torch.Tensor:
    """x[..., c] = sum_o W^{-1}[c, o] y[..., o]."""
    return torch.matmul(y, invconv_inverse_weight(params).T)


def invconv_inverse_weight(params: Params) -> torch.Tensor:
    """W^{-1} = U^{-1} L^{-1} P^T by two triangular solves; full-W takes a
    general inverse."""
    if "weight" in params:
        return torch.linalg.inv(params["weight"])
    l, u = _plu_factors(params)
    eye = torch.eye(l.shape[0], dtype=torch.float32, device=l.device)
    l_inv = torch.linalg.solve_triangular(l, eye, upper=False, unitriangular=True)
    u_inv = torch.linalg.solve_triangular(u, eye, upper=True)
    return (u_inv @ l_inv) @ params["p_mat"].T


# ---------------------------------------------------------------------------
# Affine coupling
# ---------------------------------------------------------------------------

def init_coupling(rng, channels: int, width: int = 512) -> Params:
    """The net maps C/2 -> C (log-scale and bias halves)."""
    return {"net": init_coupling_net(as_host_rng(rng), channels // 2, width, channels)}


def _halves(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    c = t.shape[-1]
    return t[..., : c // 2], t[..., c // 2:]


def coupling_forward(params: Params, x: torch.Tensor, ldj: torch.Tensor,
                     dtype: torch.dtype = torch.float32, model=None,
                     rows=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """scale = sigmoid(log_scale + 2); y_b = (x_b + bias) * scale;
    ldj += sum log(scale + 1e-6)."""
    x_a, x_b = _halves(x)
    with annotate("coupling.cnn"):
        log_scale, bias = _halves(coupling_net_apply(params["net"], x_a, dtype, model, rows))
    with annotate("flow.tail"):
        scale = torch.sigmoid(log_scale + 2.0)
        y_b = (x_b + bias) * scale
        ldj = ldj + torch.sum(torch.log(scale + _EPS_COUPLING).reshape(x.shape[0], -1), dim=1)
        return torch.cat([x_a, y_b], dim=-1), ldj


def coupling_inverse(params: Params, y: torch.Tensor,
                     dtype: torch.dtype = torch.float32, model=None) -> torch.Tensor:
    """x_b = y_b / (scale + 1e-6) - bias."""
    y_a, y_b = _halves(y)
    with annotate("coupling.cnn"):
        log_scale, bias = _halves(coupling_net_apply(params["net"], y_a, dtype, model))
    with annotate("flow.tail"):
        scale = torch.sigmoid(log_scale + 2.0)
        return torch.cat([y_a, y_b / (scale + _EPS_COUPLING) - bias], dim=-1)


@torch.no_grad()
def coupling_ddinit(params: Params, x: torch.Tensor,
                    model=None) -> Tuple[Params, torch.Tensor]:
    """Data-dependent init of the actnorms inside the coupling CNN, then a
    normal forward (the coupling output itself needs no init)."""
    new = {"net": coupling_net_ddinit(params["net"], _halves(x)[0], model)[0]}
    zeros = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    return new, coupling_forward(new, x, zeros, model=model)[0]


# ---------------------------------------------------------------------------
# Squeeze (space-to-depth, factor 2), channel order (c, h2, w2)
# ---------------------------------------------------------------------------

def squeeze_forward(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, 4C], channel order (c, h2, w2)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # b, h/2, w/2, c, h2, w2
    return x.reshape(b, h // 2, w // 2, c * 4)


def squeeze_inverse(y: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, 2H, 2W, C/4]."""
    b, h, w, c = y.shape
    y = y.reshape(b, h, w, c // 4, 2, 2)
    y = y.permute(0, 1, 4, 2, 5, 3)  # b, h, h2, w, w2, c/4
    return y.reshape(b, h * 2, w * 2, c // 4)


# ---------------------------------------------------------------------------
# Split with a learned per-split prior
# ---------------------------------------------------------------------------

def init_split(channels: int, learn_prior: bool = True) -> Params:
    """ZeroConv(C/2 -> C) for the factored half's (mean, log_sd), or a
    standard-normal prior when `learn_prior` is False."""
    if not learn_prior:
        return {"conv": None}
    return {"conv": init_zeroconv(channels // 2, channels, filter_size=3)}


def _split_prior_moments(params: Params, y: torch.Tensor,
                         rows=None) -> Tuple[torch.Tensor, torch.Tensor]:
    if params["conv"] is None:
        zeros = torch.zeros_like(y)
        return zeros, zeros
    return _halves(zeroconv_apply(params["conv"], y, rows))


def split_forward(params: Params, x: torch.Tensor, ldj: torch.Tensor,
                  logp: Optional[torch.Tensor], rows=None):
    """Channel-halve; add the factored half's prior log-density to `logp`
    when it is given. Returns (y, ldj, z, logp)."""
    y, z = _halves(x)
    if logp is not None:
        mean, logsd = _split_prior_moments(params, y, rows)
        logp = logp + gaussian_logp(z, mean, logsd)
    return y, ldj, z, logp


def split_inverse(params: Params, y: torch.Tensor, z: Optional[torch.Tensor],
                  generator: Optional[torch.Generator] = None,
                  temperature: float = 1.0,
                  eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Concatenate the factored half back; when z is None, sample it from the
    split prior at `temperature` (from `eps` if given, else `generator`)."""
    if z is None:
        mean, logsd = _split_prior_moments(params, y)
        z = gaussian_sample(generator, mean, logsd, temperature, eps)
    return torch.cat([y, z], dim=-1)


# ---------------------------------------------------------------------------
# Isotropic Gaussian density / sampling
# ---------------------------------------------------------------------------

def gaussian_logp(x: torch.Tensor, mean: torch.Tensor, logsd: torch.Tensor) -> torch.Tensor:
    """Per-sample log N(x; mean, e^{2 logsd}) summed over non-batch dims."""
    ll = -0.5 * (_LOG_2PI + 2.0 * logsd + (x - mean) ** 2 * torch.exp(-2.0 * logsd))
    return torch.sum(ll.reshape(x.shape[0], -1), dim=1)


def gaussian_sample(generator: Optional[torch.Generator], mean: torch.Tensor,
                    logsd: torch.Tensor, temperature: float = 1.0,
                    eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mean + (e^{logsd} * temperature) * eps, eps ~ N(0, 1) from
    `generator` unless given."""
    if eps is None:
        eps = draws.randn(mean.shape, generator, mean.device, mean.dtype)
    return mean + (torch.exp(logsd) * temperature) * eps


# ---------------------------------------------------------------------------
# One Glow step: actnorm -> 1x1 conv -> coupling
# ---------------------------------------------------------------------------

def init_step(rng, channels: int, width: int = 512, invconv_param: str = "plu") -> Params:
    rng = as_host_rng(rng)
    init_ic = init_invconv_full if invconv_param == "full" else init_invconv
    return {
        "actnorm": init_actnorm(channels),
        "invconv": init_ic(rng, channels),
        "coupling": init_coupling(rng, channels, width),
    }


def fold_actnorm_invconv(an: Params, ic: Params):
    """W (e^s * (x + b)) = x @ (W diag(e^s))^T + W (e^s * b).

    Returns (w_fold [O, C], b_fold [O], per-pixel logdet scalar)."""
    wmat = invconv_weight(ic)
    es = torch.exp(an["scale"])
    w_fold = wmat * es[None, :]
    b_fold = wmat @ (es * an["bias"])
    return w_fold, b_fold, torch.sum(an["scale"]) + invconv_logdet(ic)


def _inverse_fold(an: Params, ic: Params) -> torch.Tensor:
    """diag(e^-s) W^{-1}, [C, O]."""
    return torch.exp(-an["scale"])[:, None] * invconv_inverse_weight(ic)


def fused_actnorm_invconv_forward(an: Params, ic: Params, x: torch.Tensor,
                                  ldj: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """actnorm + 1x1 conv as one matmul plus bias;
    ldj += H*W*(sum(s) + log|det W|)."""
    h, w = x.shape[1], x.shape[2]
    with annotate("flow.fold"):
        w_fold, b_fold, ld = fold_actnorm_invconv(an, ic)
    with annotate("flow.mix"):
        y = torch.matmul(x, w_fold.T) + b_fold
        return y, ldj + (h * w) * ld


def fused_invconv_actnorm_inverse(an: Params, ic: Params, y: torch.Tensor) -> torch.Tensor:
    """Inverse of the fused pair: x = y @ (diag(e^-s) W^{-1})^T - b."""
    with annotate("flow.fold"):
        w_inv = _inverse_fold(an, ic)
    with annotate("flow.mix"):
        return torch.matmul(y, w_inv.T) - an["bias"]


def step_forward(params: Params, x: torch.Tensor, ldj: torch.Tensor,
                 use_kernels: bool = False, dtype: torch.dtype = torch.float32,
                 model=None, rows=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Glow step; `model` (a parallel/tensor_parallel.ModelAxis) when
    the step holds a rank's slabs of its coupling CNN (ops/coupling.py),
    `rows` when `x` is a rank's row block of the image. Either route runs
    its parts in the spans flow.fold, flow.mix, coupling.cnn and flow.tail
    inside flow.step."""
    with annotate("flow.step"):
        if use_kernels:
            return step_forward_kernels(params, x, ldj, dtype, model, rows)
        y, ldj = fused_actnorm_invconv_forward(params["actnorm"], params["invconv"], x, ldj)
        return coupling_forward(params["coupling"], y, ldj, dtype, model, rows)


def step_forward_kernels(params: Params, x: torch.Tensor, ldj: torch.Tensor,
                         dtype: torch.dtype = torch.float32, model=None,
                         rows=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Glow step through the kernels: the folded channel mix, the coupling
    CNN up to its zeroconv's convolution (cuDNN), then the step tail in one
    launch: the zeroconv's bias and scale, the coupling tail on the second
    half with its logdet, the first half passed through and the logdet
    added to the running one. The input may be a view (a squeeze); the
    channel mix takes it contiguous."""
    h, w = x.shape[1], x.shape[2]
    with annotate("flow.fold"):
        w_fold, b_fold, ld = fold_actnorm_invconv(params["actnorm"], params["invconv"])
    with annotate("flow.mix"):
        y = channel_mix(x.contiguous(), w_fold, b_fold)
        ldj = ldj + (h * w) * ld
    net = params["coupling"]["net"]
    with annotate("coupling.cnn"):
        r = coupling_net_conv(net, _halves(y)[0], dtype, model, rows)
    with annotate("flow.tail"):
        return coupling_step_tail(y, r, net["zconv"]["b"], net["zconv"]["logs"], ldj)


def step_forward_megakernel(params: Params, x: torch.Tensor,
                            ldj: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Glow step through the whole-step megakernel: the actnorm and the 1x1
    conv folded, the kernel (channel mix, coupling CNN and tail in one
    launch), then the mix's H*W*(sum s + log|det W|). Forward only: raises
    where a gradient is asked for. The input may be a view (a squeeze, a
    split); the kernel takes it contiguous."""
    h, w = x.shape[1], x.shape[2]
    w_fold, b_fold, ld = fold_actnorm_invconv(params["actnorm"], params["invconv"])
    y, ldj_part = step_megakernel_forward(x.contiguous(), w_fold, b_fold,
                                          params["coupling"]["net"])
    return y, ldj + (h * w) * ld + ldj_part


@torch.no_grad()
def step_ddinit(params: Params, x: torch.Tensor, model=None) -> Tuple[Params, torch.Tensor]:
    """Data-dependent init through one step: init the step's actnorm on its
    input, run the 1x1 conv, then init the coupling CNN's actnorms. Returns
    (new step, output); `params` is not changed."""
    an, y = actnorm_ddinit(x)
    y = torch.matmul(y, invconv_weight(params["invconv"]).T)
    cp, y = coupling_ddinit(params["coupling"], y, model)
    return {"actnorm": an, "invconv": params["invconv"], "coupling": cp}, y


def step_inverse(params: Params, y: torch.Tensor, use_kernels: bool = False,
                 dtype: torch.dtype = torch.float32, model=None) -> torch.Tensor:
    with annotate("flow.step"):
        if use_kernels:
            return step_inverse_kernels(params, y, dtype, model)
        x = coupling_inverse(params["coupling"], y, dtype, model)
        return fused_invconv_actnorm_inverse(params["actnorm"], params["invconv"], x)


def step_inverse_kernels(params: Params, y: torch.Tensor,
                         dtype: torch.dtype = torch.float32, model=None) -> torch.Tensor:
    """Inverse step through the kernels: the coupling CNN up to its
    zeroconv's convolution (cuDNN), then the inverse step tail in one
    launch (the zeroconv's bias and scale, the inverse tail on the second
    half, the first half passed through, x written whole), then the channel
    mix with weight diag(e^-s) W^{-1} and bias -b, which is the fused
    inverse's "- b" term in the kernel's matmul-plus-bias form. The mix's
    weight and bias are made first, so that nothing runs between the
    convolution, the tail and the mix. The input may be a view; the tail
    takes it contiguous."""
    an = params["actnorm"]
    with annotate("flow.fold"):
        w_inv, b_inv = _inverse_fold(an, params["invconv"]).contiguous(), -an["bias"]
    y = y.contiguous()
    net = params["coupling"]["net"]
    with annotate("coupling.cnn"):
        r = coupling_net_conv(net, _halves(y)[0], dtype, model)
    with annotate("flow.tail"):
        x = coupling_step_tail_inverse(y, r, net["zconv"]["b"], net["zconv"]["logs"])
    with annotate("flow.mix"):
        return channel_mix(x, w_inv, b_inv)
