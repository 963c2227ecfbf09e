"""Operations of the diffusion prior's UNet, from the configuration's
shapes (perfbench/reference/unet.py's architecture), per image and call:
2 per multiply-add of every convolution (init 7x7; each resnet's two 3x3
and its 1x1 where the width changes; down- and upsampling; the final 1x1),
of the attention's projections and of its per-head products. The time
embedding's dense layers run once per call, not per image, and are left
out. The linear attention's work per call at (n tokens, c channels), heads
4 of 32: the qkv projection 2 n c 384, k^T v and q ctx 2 n 128 32 each, the
out-projection 2 n 128 c; bytes: x read and y written (2 n c), the weights
(4 128 c + 2 c) once.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

HIDDEN, DIM_HEAD, HEADS = 128, 32, 4


def _conv(h: int, w: int, cin: int, cout: int, k: int) -> int:
    return 2 * h * w * cin * cout * k * k


def _resnet(h, w, d_in, d_out) -> int:
    return (_conv(h, w, d_in, d_out, 3) + _conv(h, w, d_out, d_out, 3)
            + (_conv(h, w, d_in, d_out, 1) if d_in != d_out else 0))


def linear_attention_ops(n: int, c: int) -> int:
    return 2 * n * (3 * c * HIDDEN + 2 * HIDDEN * DIM_HEAD + HIDDEN * c)


def linear_attention_bytes(batch: int, n: int, c: int) -> int:
    return 4 * (2 * batch * n * c + 4 * HIDDEN * c + 2 * c)


def full_attention_ops(n: int, c: int) -> int:
    return 2 * n * (3 * c * HIDDEN + HIDDEN * c) + 2 * 2 * HEADS * n * n * DIM_HEAD


def walk(size: int, channels: int, dim: int, dim_mults: Sequence[int]
         ) -> Tuple[int, List[Tuple[int, int]]]:
    """(operations per image, [(tokens, channels) of each linear
    attention]) of one UNet call on a (size, size, channels) input."""
    dims = [dim] + [dim * m for m in dim_mults]
    levels = list(zip(dims[:-1], dims[1:]))
    s, ops, attn = size, _conv(size, size, channels, dim, 7), []
    sizes = []
    for i, (d_in, d_out) in enumerate(levels):
        ops += 2 * _resnet(s, s, d_in, d_in) + linear_attention_ops(s * s, d_in)
        attn.append((s * s, d_in))
        sizes.append(s)
        if i == len(levels) - 1:
            ops += _conv(s, s, d_in, d_out, 3)
        else:
            s //= 2
            ops += _conv(s, s, 4 * d_in, d_out, 1)
    mid = levels[-1][1]
    ops += 2 * _resnet(s, s, mid, mid) + full_attention_ops(s * s, mid)
    for i, (d_in, d_out) in enumerate(reversed(levels)):
        ops += 2 * _resnet(s, s, d_out + d_in, d_out) + linear_attention_ops(s * s, d_out)
        attn.append((s * s, d_out))
        if i == len(levels) - 1:
            ops += _conv(s, s, d_out, d_in, 3)
        else:
            s *= 2
            ops += _conv(s, s, d_out, d_in, 3)
    ops += _resnet(s, s, 2 * dim, dim) + _conv(s, s, dim, channels, 1)
    return ops, attn


def prior_work(config: Dict, parts: Sequence[Tuple[int, int, int]]) -> Dict[str, int]:
    """Per image of one sampling call: the UNets' operations over the whole
    chain, and the chain's linear attentions [(tokens, channels)] per
    image-call (each repeated for every step)."""
    u, steps = config["unet"], config["diffusion"]["sampling_timesteps"]
    ops, attn = 0, []
    for h, _w, c in parts:
        o, a = walk(h, c, u["dim"], u["dim_mults"])
        ops += steps * o
        attn += a * steps
    return {"ops": ops, "attention": attn}
