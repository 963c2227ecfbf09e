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
it and how it is laid out): every product on the tensor cores in 3xTF32, a
block a run of consecutive pixels, the zeroconv in scatter form (no halo),
then a gather-and-tail kernel. Its plan is `plan`, a pure function of the
shape that the entry point checks; there is no `tile_b`. The JAX function
has no VJP, and neither has this one: it raises where a gradient is asked
for. Nothing in the Glow wires it in (the JAX
package keeps it as a tested experiment too); `bijectors.step_forward`
stays the model's route.
"""

from __future__ import annotations

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


SMS = 132                # H100 SXM
SMEM_LIMIT = 232448      # a block's shared memory on Hopper


def kch(mt: int) -> int:
    """Rows of a streamed operand per ring stage (csrc/step_megakernel.cu:
    kch): 32, or 16 at mt = 1, whose stages are 512 columns wide."""
    return 16 if mt == 1 else 32


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def z_cols(c: int) -> int:
    """Columns of the scatter zeroconv's output Z: 9 C rounded up to 8."""
    return _round_up(9 * c, 8)


def smem_bytes(w: int, c: int, d: int, mt: int, stages: int) -> int:
    """A block's dynamic shared memory (csrc/step_megakernel.cu: layout_for):
    y_a on its 16 mt pixels +- (W + 1), h1 [16 mt, D], the ring of `stages`
    stages of kch(mt) rows, and the largest of x's rows and wf's first half
    (for y_a), conv1's im2col tile and a chunk of h2."""
    m, nc, half, k = 16 * mt, 512 // mt, c // 2, kch(mt)
    ya = _round_up((m + 2 * w + 2) * half, 4)
    h1 = m * _round_up(d, k)
    ring = stages * k * nc
    work = max(m * _round_up(9 * half, k), m * nc, (m + 2 * w + 2 + half) * c)
    return 4 * (ya + h1 + ring + work)


def frag_b(w: torch.Tensor) -> torch.Tensor:
    """A weight [K, N] in the kernel's B-fragment layout: K and N padded
    with zeros to multiples of 8, then block (kg, nt) of 64 values holds, at
    lane * 2 + i, the element (8 kg + 2 (lane % 4) + i, 8 nt + lane // 4):
    one thread's two values of an m16n8k8 B fragment, one 8-byte load."""
    k, n = w.shape
    w = F.pad(w, (0, -n % 8, 0, -k % 8))
    kg, nt = w.shape[0] // 8, w.shape[1] // 8
    # rows 8 kg + 2 t + i, columns 8 nt + g -> [kg, nt, g, t, i]
    return w.reshape(kg, 4, 2, nt, 8).permute(0, 3, 4, 1, 2).contiguous()


class Plan(NamedTuple):
    """The kernel's plan for one shape: a block takes 16 mt consecutive
    pixels of the flattened [B, H, W] (mt row tiles of the tensor-core
    products, 512 / mt hidden channels a chunk), `stages` buffers in its
    cp.async ring; `blocks` blocks, `smem` bytes of dynamic shared memory
    each."""
    mt: int
    stages: int
    blocks: int
    smem: int


@functools.lru_cache(maxsize=64)
def plan(batch: int, h: int, w: int, c: int, width: int) -> Optional[Plan]:
    """The plan for x [batch, h, w, c] at hidden width `width`, or None where
    none fits (C odd, a width that is not a positive multiple of 4, or too
    wide for shared memory). A pure function of the shape: of the mt whose
    zeroconv columns fit a warp's 8 / mt column tiles, the one with the
    fewest waves (of one block an SM) x mt, the largest on a tie (2 x 4 at
    the first level, 1 x 2 at the second, 1 x 1 at the third); the deepest
    ring (4, 3, 2) that fits."""
    if batch <= 0 or h <= 0 or w <= 0 or c <= 0 or c % 2 or width <= 0 or width % 4:
        return None
    n = batch * h * w
    best, best_cost = None, None
    for mt in (4, 2, 1):
        if -(-z_cols(c) // 64) > 8 // mt:
            continue
        stages = next((s for s in (4, 3, 2) if smem_bytes(w, c, width, mt, s) <= SMEM_LIMIT),
                      None)
        if stages is None:
            continue
        blocks = -(-n // (16 * mt))
        cost = -(-blocks // SMS) * mt
        if best is None or cost < best_cost:
            best = Plan(mt, stages, blocks, smem_bytes(w, c, width, mt, stages))
            best_cost = cost
    return best


def halo_waste(p: Plan, batch: int, h: int, w: int) -> float:
    """Pixels the kernel runs conv1, the 1x1 conv and the zeroconv on per
    output pixel: blocks x 16 mt over B H W (the scatter zeroconv needs no
    border; the last block's rows past the end still run through the
    products). y_a, a C x C/2 mix, is made on each block's pixels +- (W + 1)."""
    return p.blocks * 16 * p.mt / (batch * h * w)


def pack(w_fold: torch.Tensor, b_fold: torch.Tensor, net: Params, c: int):
    """The weights as the kernel takes them: the first conv tap-major [9
    C/2, D], the 1x1 conv as [in, out], the zeroconv in scatter form [D, 9
    C] (column tap C + c: the tap's weight to output channel c) padded with
    zero columns to z_cols(C); those three in the B-fragment layout
    (`frag_b`). The port keeps conv weights channels-last, so each is
    copied out explicitly."""
    wz = taps(net["zconv"]["w"])  # [9, D, C]
    d = wz.shape[1]
    wz = F.pad(wz.permute(1, 0, 2).reshape(d, 9 * c), (0, z_cols(c) - 9 * c))
    return [w_fold.contiguous(), b_fold.contiguous(),
            frag_b(taps(net["conv1"]["w"]).reshape(9 * (c // 2), d)),
            net["an1"]["scale"].contiguous(), net["an1"]["bias"].contiguous(),
            frag_b(net["conv2"]["w"][:, :, 0, 0].T),
            net["an2"]["scale"].contiguous(), net["an2"]["bias"].contiguous(),
            frag_b(wz), net["zconv"]["b"].contiguous(), net["zconv"]["logs"].contiguous()]


def launch(x: torch.Tensor, packed, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel (and of its gather-and-tail kernel) on CUDA
    operands, the weights already packed (`pack`). The wrapper packs them
    on every call; a caller that times the kernel alone packs once."""
    device = _build.check_cuda_f32("step_megakernel_forward", x, *packed)
    b, h, w, c = x.shape
    p = plan(b, h, w, c, width)
    if p is None:
        raise ValueError(f"step_megakernel_forward: no tiling of the kernel fits hidden "
                         f"width {width} (it takes multiples of 4 that fit in shared "
                         "memory)")
    y = torch.empty_like(x)
    z = torch.empty((b * h * w, z_cols(c)), dtype=torch.float32, device=device)
    ldj = torch.empty((b,), dtype=torch.float32, device=device)
    _build.launch("step_megakernel_forward",
                  _build.function("step_megakernel", "step_megakernel_f32"), device,
                  x.data_ptr(), *(t.data_ptr() for t in packed), y.data_ptr(), z.data_ptr(),
                  ldj.data_ptr(), b, h, w, c, width, p.mt, p.stages)
    step_megakernel_forward.launches += 1
    return y, ldj


def step_megakernel_forward(x: torch.Tensor, w_fold: torch.Tensor, b_fold: torch.Tensor,
                            net: Params) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, H, W, C] fp32, w_fold [C, C], b_fold [C], net the coupling-CNN
    tree (ops/coupling.init_coupling_net) -> (y [B, H, W, C], ldj_part [B]).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises. Not differentiable: raises where a gradient is asked for."""
    _build.refuse_gradient("step_megakernel_forward",
                           "the JAX megakernel is forward only; use "
                           "bijectors.step_forward", x, w_fold, b_fold, *_leaves(net))
    width = _check(x, w_fold, b_fold, net)
    if x.device.type == "cpu":
        return step_megakernel_forward_plain(x, w_fold, b_fold, net)
    return launch(x, pack(w_fold, b_fold, net, x.shape[-1]), width)


step_megakernel_forward.launches = 0
