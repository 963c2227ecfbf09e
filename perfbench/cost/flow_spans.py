"""The work the flow spans enclose beyond perfbench/cost/glow.py's
mix_tail_work, which counts the mix and tail kernels alone.

In a backward pass the span flow.mix.bwd also holds the mix's weight and
bias gradients, dW = g^T x and db = sum g, made by torch.matmul and a sum
beside the dx kernel. Over n = B h w pixels of C channels (C = O): read x
(n C; g is counted in the dx kernel's bytes), write dW (C^2) and db (C),
fp32; 2 n C^2 operations for dW and n C for db.
"""

from __future__ import annotations

from typing import Dict, Tuple

from .glow import level_shapes


def mix_weight_grad_work(config: Dict, batch: int) -> Tuple[int, int]:
    """(bytes, operations) of every step's dW and db in one backward pass at
    `batch` images."""
    k = config["flow"]["K"]
    nbytes = ops = 0
    for h, w, c in level_shapes(config):
        n = batch * h * w
        nbytes += k * 4 * (n * c + c * c + c)
        ops += k * (2 * n * c * c + n * c)
    return nbytes, ops
