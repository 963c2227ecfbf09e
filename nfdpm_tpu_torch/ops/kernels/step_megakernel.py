"""One whole Glow step in one kernel, forward only: CUDA kernel wrapper and
plain version.

    y = x w_fold^T + b_fold;  y_a, x_b = split(y)
    net = coupling CNN(y_a)   (3x3 conv, actnorm, ReLU; 1x1 conv, actnorm,
                               ReLU; zeroconv scaled by exp(3 logs))
    ls, t = split(net);  s = sigmoid(ls + 2);  y_b = (x_b + t) s
    ldj_part[b] = sum log(s + 1e-6)

Counterpart of nfdpm_tpu/ops/pallas/step_megakernel.py, with its contract:
`ldj_part` leaves out the channel mix's H*W*(sum s + log|det W|), which the
caller adds (ops/bijectors.py:step_forward_megakernel). The kernel is
`step_megakernel_f32` in csrc/step_megakernel.cu (its note says what bounds
it and how it is tiled); it picks its own tiling per shape, so there is no
`tile_b`. The JAX function has no VJP, and neither has this one: it raises
where a gradient is asked for. Nothing in the Glow wires it in (the JAX
package keeps it as a tested experiment too); `bijectors.step_forward`
stays the model's route.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .coupling_tail import coupling_tail_plain
from ..coupling import coupling_net_apply

Params = Dict[str, Any]


def taps(w_oihw: torch.Tensor) -> torch.Tensor:
    """A 3x3 conv weight, OIHW [Cout, Cin, 3, 3] -> [9, Cin, Cout], tap-major
    in the order (dh + 1) * 3 + (dw + 1), as JAX's `_taps` of the HWIO weight."""
    cout, cin, kh, kw = w_oihw.shape
    return w_oihw.permute(2, 3, 1, 0).reshape(kh * kw, cin, cout).contiguous()


def _check(x: torch.Tensor, w_fold: torch.Tensor, b_fold: torch.Tensor,
           net: Params) -> int:
    """Raise unless the shapes make one Glow step; returns the hidden width."""
    if x.dim() != 4:
        raise ValueError(f"step_megakernel_forward: x must be [B, H, W, C], got "
                         f"{tuple(x.shape)}")
    c = x.shape[-1]
    if c % 2:
        raise ValueError(f"step_megakernel_forward: C = {c} is odd; the coupling "
                         "splits it in halves")
    width = net["conv1"]["w"].shape[0]
    expect = {"w_fold": (w_fold, (c, c)), "b_fold": (b_fold, (c,)),
              "conv1.w": (net["conv1"]["w"], (width, c // 2, 3, 3)),
              "an1.scale": (net["an1"]["scale"], (width,)),
              "an1.bias": (net["an1"]["bias"], (width,)),
              "conv2.w": (net["conv2"]["w"], (width, width, 1, 1)),
              "an2.scale": (net["an2"]["scale"], (width,)),
              "an2.bias": (net["an2"]["bias"], (width,)),
              "zconv.w": (net["zconv"]["w"], (c, width, 3, 3)),
              "zconv.b": (net["zconv"]["b"], (c,)),
              "zconv.logs": (net["zconv"]["logs"], (c,))}
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"step_megakernel_forward: {name} is {tuple(t.shape)}, "
                             f"expected {shape} for C = {c} and width {width}")
    return width


def _leaves(net: Params):
    return [v for layer in net.values() for v in layer.values()]


def step_megakernel_forward_plain(x: torch.Tensor, w_fold: torch.Tensor,
                                  b_fold: torch.Tensor,
                                  net: Params) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the mix as a matmul, the coupling CNN through
    zeroconv.conv2d_nhwc, the tail's formulas. x [B, H, W, C] ->
    (y [B, H, W, C], ldj_part [B])."""
    c = x.shape[-1]
    y = torch.matmul(x, w_fold.T) + b_fold
    y_a, x_b = y[..., : c // 2], y[..., c // 2:]
    out = coupling_net_apply(net, y_a)
    y_b, ldj = coupling_tail_plain(out[..., : c // 2], out[..., c // 2:], x_b)
    return torch.cat([y_a, y_b], dim=-1), ldj


class Plan(NamedTuple):
    """The kernel's tiling of one shape (csrc/step_megakernel.cu, plan_for):
    th x tw output pixels per block, nc hidden channels per chunk of h2,
    slots 4x4 quads of the 1x1 conv per thread, ks threads per zeroconv
    output, smem bytes of dynamic shared memory."""
    th: int
    tw: int
    nc: int
    slots: int
    ks: int
    smem: int


@functools.lru_cache(maxsize=64)
def plan(batch: int, h: int, w: int, c: int, width: int) -> Optional[Plan]:
    """The kernel's plan for x [batch, h, w, c] at hidden width `width`, or
    None where no tiling fits (width not a multiple of 4, or too wide)."""
    out = (ctypes.c_int * 5)()
    smem = _build.function("step_megakernel", "step_megakernel_plan")(batch, h, w, c, width, out)
    return None if smem < 0 else Plan(*out, smem)


def halo_waste(p: Plan, h: int, w: int) -> float:
    """Pixels of h1 and h2 the kernel computes per output pixel: each tile
    also computes its one-pixel border that lies inside the image."""
    rows = sum(min(h, r + p.th + 1) - max(0, r - 1) for r in range(0, h, p.th))
    cols = sum(min(w, s + p.tw + 1) - max(0, s - 1) for s in range(0, w, p.tw))
    return rows * cols / (h * w)


def pack(w_fold: torch.Tensor, b_fold: torch.Tensor, net: Params, c: int):
    """The weights as the kernel takes them: 3x3 convs tap-major, the 1x1
    conv as [in, out], the zeroconv's columns padded with zeros to a
    multiple of 4. The port keeps conv weights channels-last, so each is
    copied out explicitly."""
    wz = taps(net["zconv"]["w"])
    if c % 4:
        wz = F.pad(wz, (0, 4 - c % 4))
    return [w_fold.contiguous(), b_fold.contiguous(), taps(net["conv1"]["w"]),
            net["an1"]["scale"].contiguous(), net["an1"]["bias"].contiguous(),
            net["conv2"]["w"][:, :, 0, 0].T.contiguous(),
            net["an2"]["scale"].contiguous(), net["an2"]["bias"].contiguous(),
            wz.contiguous(), net["zconv"]["b"].contiguous(),
            net["zconv"]["logs"].contiguous()]


def launch(x: torch.Tensor, packed, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel (and of its per-image sum) on CUDA operands,
    the weights already packed (`pack`). The wrapper packs them on every
    call; a caller that times the kernel alone packs once."""
    device = _build.check_cuda_f32("step_megakernel_forward", x, *packed)
    b, h, w, c = x.shape
    p = plan(b, h, w, c, width)
    if p is None:
        raise ValueError(f"step_megakernel_forward: no tiling of the kernel fits hidden "
                         f"width {width} (it takes multiples of 4 that fit in shared "
                         "memory)")
    y = torch.empty_like(x)
    rows = torch.empty((b, h, w), dtype=torch.float32, device=device)
    ldj = torch.empty((b,), dtype=torch.float32, device=device)
    _build.launch("step_megakernel_forward",
                  _build.function("step_megakernel", "step_megakernel_f32"), device,
                  x.data_ptr(), *(t.data_ptr() for t in packed), y.data_ptr(), rows.data_ptr(),
                  ldj.data_ptr(), b, h, w, c, width, p.th, p.tw, p.nc)
    step_megakernel_forward.launches += 1
    return y, ldj


def step_megakernel_forward(x: torch.Tensor, w_fold: torch.Tensor, b_fold: torch.Tensor,
                            net: Params) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, H, W, C] fp32, w_fold [C, C], b_fold [C], net the coupling-CNN
    tree (ops/coupling.init_coupling_net) -> (y [B, H, W, C], ldj_part [B]).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises. Not differentiable: raises where a gradient is asked for."""
    _build.refuse_gradient("step_megakernel_forward",
                           "§2.5: the JAX megakernel is forward only; use "
                           "bijectors.step_forward", x, w_fold, b_fold, *_leaves(net))
    width = _check(x, w_fold, b_fold, net)
    if x.device.type == "cpu":
        return step_megakernel_forward_plain(x, w_fold, b_fold, net)
    return launch(x, pack(w_fold, b_fold, net, x.shape[-1]), width)


step_megakernel_forward.launches = 0
