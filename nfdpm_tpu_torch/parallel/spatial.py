"""Spatial partitioning: image rows of the flow over the model axis.

Counterpart of what GSPMD writes for the JAX package's P("data", "model")
constraint on the dequantized batch (nfdpm_tpu/parallel/mesh.py
spatial_sharding): model rank m of a model group holds rows
[m H/n, (m+1) H/n) of every flow activation, and the whole flow. The port
has no compiler to place the communication, so the layers call these:

  halo              the rows a k x k SAME convolution of a rank's rows reads
                    across the cut: the rank's first and last (k-1)/2 rows
                    sent to its neighbours on the model group, theirs
                    received, zeros at the image's top and bottom
                    (ops/zeroconv.conv2d_nhwc_rows stacks them above and
                    below the rank's own and convolves with no padding
                    over H).
  halo_backward     its backward: each halo row's gradient sent back to the
                    rank that owns the row, which adds it to its own edge
                    row.
  cut_rows          the rank's row block of a whole tensor (the images and
                    their dequantization noise).
  gather_rows       the row blocks joined into whole images on every rank:
                    all-gather forward, the rank's own block of the
                    gradient backward (tensor_parallel.gather_from_model
                    along H): every rank computes the same loss of the whole
                    latents, so their gradient is not summed.
  all_reduce_sum_   the parameters' gradients summed over the model group:
                    each rank's are the part of its rows.

The per-image partial sums (a logdet, a log-density) are summed over the
model group by tensor_parallel.reduce_from_model (all-reduce forward,
identity backward). The exchange is exact at any row count a shard (1 row
at 3x3 too). The guard (mesh.checked_spatial) is nevertheless the JAX
package's, so the two packages accept the same configurations. Without a
model axis (None, or one rank) cut_rows, gather_rows and all_reduce_sum_
do what one device does: nothing. Each exchange is a set of
point-to-point sends and receives between neighbours, all posted together
(tensor_parallel.p2p: gloo moves CUDA tensors through host copies); every
rank of a model group runs the same sequence of them, in the forward and
in the backward (also when `GlowConfig.remat` recomputes a step), so they
pair up.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .tensor_parallel import ModelAxis, active, all_gather_dim, p2p


def halo(x: torch.Tensor, axis: ModelAxis, p: int):
    """The `p` rows above and below the rank's rows `x` [B, h, W, C]: the
    neighbours' edge rows, zeros at the image's top and bottom (one
    exchange with the neighbours on the model group)."""
    b, h, w, c = x.shape
    if h < p:
        raise ValueError(f"a shard of {h} rows cannot give a halo of {p} rows")
    up, down = axis.index - 1, axis.index + 1
    above, below = x.new_zeros((b, p, w, c)), x.new_zeros((b, p, w, c))
    sends, recvs = [], []
    if up >= 0:
        sends.append((x[:, :p].contiguous(), up))
        recvs.append((above, up))
    if down < axis.n:
        sends.append((x[:, h - p:].contiguous(), down))
        recvs.append((below, down))
    p2p(axis, sends, recvs)
    return above, below


def halo_backward(gxp: torch.Tensor, axis: ModelAxis, p: int) -> torch.Tensor:
    """The gradient of the rank's rows from that of its rows with their
    halo: each halo row's gradient sent back to the rank that owns the row,
    which adds it to its own edge row."""
    b, h, w, c = gxp.shape
    h -= 2 * p
    up, down = axis.index - 1, axis.index + 1
    dx = gxp[:, p:p + h].clone(memory_format=torch.contiguous_format)
    sends, recvs = [], []
    from_above = from_below = None
    if up >= 0:  # the rows above are the upper neighbour's last rows
        from_above = dx.new_empty((b, p, w, c))
        sends.append((gxp[:, :p].contiguous(), up))
        recvs.append((from_above, up))
    if down < axis.n:
        from_below = dx.new_empty((b, p, w, c))
        sends.append((gxp[:, p + h:].contiguous(), down))
        recvs.append((from_below, down))
    p2p(axis, sends, recvs)
    if from_above is not None:
        dx[:, :p] += from_above
    if from_below is not None:
        dx[:, h - p:] += from_below
    return dx


def cut_rows(axis: Optional[ModelAxis], x: torch.Tensor) -> torch.Tensor:
    """The rank's contiguous block of axis 1 (H) of a whole NHWC tensor,
    [m H/n, (m+1) H/n); an H that does not divide raises."""
    if not active(axis):
        return x
    return axis.slab(x, 1).contiguous()


def _gather(axis: ModelAxis, t: torch.Tensor) -> torch.Tensor:
    """The model group's row blocks `t` joined along H (one all-gather)."""
    return all_gather_dim(axis, t, 1)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _gather(axis, x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.slab(grad, 1).contiguous(), None


def gather_rows(axis: Optional[ModelAxis], x: torch.Tensor) -> torch.Tensor:
    """The whole NHWC tensor, on every rank, from the ranks' row blocks `x`;
    its gradient is the rank's own block of the whole one's."""
    return _GatherRows.apply(x, axis) if active(axis) else x


def all_reduce_sum_(axis: Optional[ModelAxis], tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its sum over the model group, in place, with
    ONE all-reduce over a flat buffer of all of them."""
    if not active(axis) or not tensors:
        return
    from .mesh import _flat, _unflat_

    flat = _flat(tensors)
    dist.all_reduce(flat, group=axis.group)
    _unflat_(flat, tensors)
