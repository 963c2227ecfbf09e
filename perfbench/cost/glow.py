"""Operations and bytes of the Glow flow, from the configuration's shapes.

A Glow step at a level of (h, w, C), coupling width W, per image:
  channel mix (actnorm folded into the 1x1 conv): 2 h w C^2
  coupling CNN: conv3x3 C/2 -> W, conv1x1 W -> W, zeroconv3x3 W -> C:
                2 h w (9 (C/2) W + W^2 + 9 W C)
and each level's split prior (a zeroconv3x3 C/2 -> C) 2 h w 9 (C/2) C,
where the prior is evaluated (scoring, training) or drawn from (sampling a
missing part). Operations are 2 per multiply-add of the convolutions and
matrix products; a backward pass counts twice its forward.

The flow kernels' work (the mix and the coupling tail of every step): each
input byte read once and each output byte written once, over n = B h w
pixels of C fp32 channels:
  mix, either direction or its dx: read x and write y (2 n C), the C x C
      weight (and C bias); 2 n C^2 operations
  tail forward: read y and r, write the output (3 n C), 2 C parameters, the
      logdet in and out (2 B)
  tail inverse: read y and r, write x (3 n C), 2 C parameters
  tail backward: read y's transformed half, r and the cotangent, write d_y
      and d_r (9 n C / 2: d_y's first half is the cotangent's), 4 C
      parameters and their gradients, the logdet's cotangent (B)
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def level_shapes(config: Dict) -> List[Tuple[int, int, int]]:
    """(h, w, C) the steps of each level see: 32x32x3, L 3 -> (16, 16, 12),
    (8, 8, 24), (4, 4, 48)."""
    s, c = config["image"]["size"], config["image"]["channels"]
    out = []
    for _ in range(config["flow"]["L"]):
        s, c = s // 2, c * 4
        out.append((s, s, c))
        c //= 2
    return out


def step_flops(h: int, w: int, c: int, width: int) -> int:
    return 2 * h * w * (c * c + 9 * (c // 2) * width + width * width + 9 * width * c)


def split_flops(h: int, w: int, c: int) -> int:
    return 2 * h * w * 9 * (c // 2) * c


def flow_flops_per_image(config: Dict, splits: bool) -> int:
    """One pass of the flow (forward or inverse) for one image; `splits`:
    the split priors' convolutions are evaluated."""
    k, width = config["flow"]["K"], config["flow"]["coupling_width"]
    shapes = level_shapes(config)
    total = sum(k * step_flops(h, w, c, width) for h, w, c in shapes)
    if splits:
        total += sum(split_flops(h, w, c) for h, w, c in shapes[:-1])
    return total


def mix_tail_work(config: Dict, batch: int, passes: Tuple[str, ...]) -> Tuple[int, int]:
    """(bytes, operations) of the mix and the tail of every step for
    `passes` among "forward", "inverse", "backward", at `batch` images."""
    k = config["flow"]["K"]
    nbytes = ops = 0
    for h, w, c in level_shapes(config):
        n = batch * h * w
        mix_b, mix_o = 4 * (2 * n * c + c * c + c), 2 * n * c * c
        for p in passes:
            if p == "forward":
                nbytes += k * (mix_b + 4 * (3 * n * c + 2 * c + 2 * batch))
            elif p == "inverse":
                nbytes += k * (mix_b + 4 * (3 * n * c + 2 * c))
            elif p == "backward":
                nbytes += k * (4 * (2 * n * c + c * c) + 4 * (9 * n * c // 2 + 4 * c + batch))
            else:
                raise ValueError(p)
            ops += k * mix_o
    return nbytes, ops
