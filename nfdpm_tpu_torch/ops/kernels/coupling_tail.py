"""Affine-coupling tail, forward with its logdet, its gradient and its
inverse: CUDA kernel wrappers and plain versions.

    s = sigmoid(log_scale + 2);  y_b = (x_b + bias) * s;  ldj[b] = sum log(s + 1e-6)
    x_b = y_b / (sigmoid(log_scale + 2) + 1e-6) - bias

Counterpart of nfdpm_tpu/ops/pallas/coupling_tail.py. The kernels are in
csrc/flow_kernels.cu (its note says what bounds them and how they are laid
out). One forward kernel and one backward kernel serve two modes:

- the plain-operand mode, `coupling_tail(log_scale, bias, x_b)`, the JAX
  function's counterpart: three [B, ...] operands;
- the step mode, `coupling_step_tail(y, r, zb, zlogs, ldj)`, the whole tail
  of a Glow step in one launch: the zeroconv's epilogue on its raw
  convolution r, the tail on the second half of the channel mix's output y,
  the first half passed through, and the logdet added to the running ldj

      h = (r + zb) * exp(3 zlogs);  ls, bias = h[..., :C/2], h[..., C/2:]
      out = [y[..., :C/2], (y[..., C/2:] + bias) * s];  ldj' = ldj + sum log(s + 1e-6)

Both are differentiable (CouplingTailFunction, CouplingStepTailFunction);
their vector-Jacobian products are the backward kernel in the same two
modes (`_bwd` there, left to XLA in the JAX package):

    ds = s (1 - s);  d_ls = g_b (x_b + bias) ds + g_ldj[b] ds / (s + 1e-6);  d_bias = g_b s
    plain: d_x_b = d_bias
    step:  d_y = [g_a, g_b s];  d_r = [d_ls, d_bias] e  (e = exp(3 zlogs))
           d_zb = sum d_r;  d_zlogs = 3 sum [d_ls, d_bias] h  (over B, H, W)

The inverse kernel serves the same two modes: the plain-operand
`coupling_tail_inverse(log_scale, bias, y_b)` and the step mode
`coupling_step_tail_inverse(y, r, zb, zlogs)`, the whole tail of an inverse
Glow step in one launch, the inverse channel mix's input written whole:

      h = (r + zb) * exp(3 zlogs);  ls, bias = h[..., :C/2], h[..., C/2:]
      x = [y[..., :C/2], y[..., C/2:] / (sigmoid(ls + 2) + 1e-6) - bias]

The inverse has no gradient (the JAX package never differentiates it
either) and raises when one is asked for.

Each kernel's layout per shape is a plan (`forward_plan`, `backward_plan`,
`inverse_plan`), a pure function of the shape and the access width that
the wrapper hands to the kernel as arguments (the CPU tests hold it). The kernels' logdet and
per-channel sums take a fixed order. The forward adds an image's blocks'
sums within their thread-block cluster; the step-mode backward adds its
blocks' rows of per-channel sums in the block that finishes last, picked
by a ticket counter (zero between launches, reset by the kernel). There is
one counter per device and stream, so that launches on two streams never
share one: the launches that share a counter run one after another.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import _build

EPS = 1e-6
SMS = 132                # H100 SXM
MAX_INVERSE_BLOCKS = SMS * 16  # csrc/flow_kernels.cu: launch_tail_inverse; threads loop past it
MAX_THREADS = 512        # csrc/flow_kernels.cu: TAIL_MAX_THREADS
MAX_CLUSTER = 8          # csrc/flow_kernels.cu: TAIL_MAX_CLUSTER, a portable cluster
MAX_STEP_CHANNELS = 512  # csrc/flow_kernels.cu: coupling_tail_step_f32


class Plan(NamedTuple):
    vw: int           # values a thread reads with one access: 4 (16 bytes), 2 or 1
    threads: int      # a block
    blocks: int       # forward: blocks an image, one cluster (the grid is blocks x B);
                      # backward: all
    px_per_lane: int  # backward: pixels each lane of a block walks (forward: 1)


def vector_width(half: int, *ptrs: int) -> int:
    """The widest access (values) that `half` (values a pixel's tail
    transforms, or a plain row's length) and every pointer's alignment allow."""
    combined = 0
    for p in ptrs:
        combined |= p
    for vw in (4, 2):
        if half % vw == 0 and combined % (4 * vw) == 0:
            return vw
    return 1


@functools.lru_cache(maxsize=None)
def forward_plan(rows: int, px: int, half: int, vw: int) -> Plan:
    """The forward kernel's plan for `rows` images of `px` pixels whose tail
    transforms `half` values each (a plain row: px = D / vw, half = vw).

    A thread takes one unit (vw values of a pixel's half); an image's units
    go to one cluster of at most MAX_CLUSTER blocks. The threads halve from
    128 to 32 until the grid has a block per SM, and double (up to
    MAX_THREADS) while an image would need more blocks than a cluster holds;
    past that the threads walk the image's units in a loop."""
    units = px * (half // vw)
    threads = 128
    while threads > 32 and rows * -(-units // threads) < SMS:
        threads //= 2
    while threads < MAX_THREADS and -(-units // threads) > MAX_CLUSTER:
        threads *= 2
    return Plan(vw, threads, min(MAX_CLUSTER, max(1, -(-units // threads))), 1)


@functools.lru_cache(maxsize=None)
def inverse_plan(rows: int, px: int, half: int, vw: int) -> Plan:
    """The inverse kernel's plan (a plain row: rows = 1, px = n / vw, half =
    vw): a 1-D grid of one unit a thread, the threads halved from 128 to 32
    until the grid has a block per SM; past MAX_INVERSE_BLOCKS blocks the
    threads walk the units in a loop."""
    units = rows * px * (half // vw)
    threads = 128
    while threads > 32 and -(-units // threads) < SMS:
        threads //= 2
    return Plan(vw, threads, min(MAX_INVERSE_BLOCKS, max(1, -(-units // threads))), 1)


@functools.lru_cache(maxsize=None)
def backward_plan(rows: int, px: int, half: int, vw: int) -> Plan:
    """The backward kernel's plan: blocks of 256 threads (512 where 256
    would need more than a block per SM), each a set of lanes = threads /
    (half / vw) pixel lanes that walk px_per_lane pixels each, with
    px_per_lane the least that keeps the grid within one block per SM (few
    rows of per-channel sums keep the kernel's last pass short)."""
    n_px = rows * px
    threads = 256
    if -(-n_px // (threads // (half // vw))) > SMS:
        threads = MAX_THREADS
    lanes = threads // (half // vw)
    per_lane = max(1, -(-n_px // (lanes * SMS)))
    return Plan(vw, threads, max(1, -(-n_px // (lanes * per_lane))), per_lane)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def coupling_tail_plain(log_scale: torch.Tensor, bias: torch.Tensor,
                        x_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: [B, ...] inputs -> (y_b [B, ...], ldj [B])."""
    s = torch.sigmoid(log_scale + 2.0)
    y_b = (x_b + bias) * s
    ldj = torch.sum(torch.log(s + EPS).reshape(x_b.shape[0], -1), dim=1)
    return y_b, ldj


def coupling_tail_inverse_plain(log_scale: torch.Tensor, bias: torch.Tensor,
                                y_b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the inverse tail."""
    return y_b / (torch.sigmoid(log_scale + 2.0) + EPS) - bias


def coupling_tail_bwd_plain(log_scale: torch.Tensor, bias: torch.Tensor,
                            x_b: torch.Tensor, g_y: Optional[torch.Tensor],
                            g_ldj: Optional[torch.Tensor]
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the tail's vector-Jacobian product:
    (d_log_scale, d_x_b), where d_bias equals d_x_b. `g_y` [B, ...] and
    `g_ldj` [B] are the cotangents of (y_b, ldj); None counts as zeros."""
    s = torch.sigmoid(log_scale + 2.0)
    ds = s * (1.0 - s)
    d_ls = torch.zeros_like(x_b)
    d_xb = torch.zeros_like(x_b)
    if g_y is not None:
        d_ls = d_ls + g_y * (x_b + bias) * ds
        d_xb = g_y * s
    if g_ldj is not None:
        g_rows = g_ldj.reshape((-1,) + (1,) * (x_b.dim() - 1))
        d_ls = d_ls + g_rows * ds / (s + EPS)
    return d_ls, d_xb


def _epilogue(r: torch.Tensor, zb: torch.Tensor, zlogs: torch.Tensor):
    """(h, e): the zeroconv's output h = (r + zb) * e, e = exp(3 zlogs)
    (ops/zeroconv.py: zeroconv_apply)."""
    e = torch.exp(zlogs * 3.0)
    return (r + zb) * e, e


def coupling_step_tail_plain(y: torch.Tensor, r: torch.Tensor, zb: torch.Tensor,
                             zlogs: torch.Tensor, ldj: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the step tail: y, r [B, ..., C], zb, zlogs
    [C], ldj [B] -> (out [B, ..., C], ldj + the tail's logdet [B])."""
    half = y.shape[-1] // 2
    h, _ = _epilogue(r, zb, zlogs)
    y_b, ldj_part = coupling_tail_plain(h[..., :half], h[..., half:], y[..., half:])
    return torch.cat([y[..., :half], y_b], dim=-1), ldj + ldj_part


def coupling_step_tail_inverse_plain(y: torch.Tensor, r: torch.Tensor, zb: torch.Tensor,
                                     zlogs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the inverse step tail: y, r [B, ..., C], zb,
    zlogs [C] -> x [B, ..., C]."""
    half = y.shape[-1] // 2
    h, _ = _epilogue(r, zb, zlogs)
    x_b = coupling_tail_inverse_plain(h[..., :half], h[..., half:], y[..., half:])
    return torch.cat([y[..., :half], x_b], dim=-1)


def coupling_step_tail_bwd_plain(y: torch.Tensor, r: torch.Tensor, zb: torch.Tensor,
                                 zlogs: torch.Tensor, g_out: Optional[torch.Tensor],
                                 g_ldj: Optional[torch.Tensor]):
    """Plain PyTorch version of the step tail's vector-Jacobian product:
    (d_y, d_r, d_zb, d_zlogs) for the cotangents g_out [B, ..., C] and g_ldj
    [B] of (out, ldj') (None: zeros); the running ldj's own is g_ldj."""
    c = y.shape[-1]
    half = c // 2
    h, e = _epilogue(r, zb, zlogs)
    g_b = None if g_out is None else g_out[..., half:]
    d_ls, d_t = coupling_tail_bwd_plain(h[..., :half], h[..., half:], y[..., half:],
                                        g_b, g_ldj)
    g_a = torch.zeros_like(d_t) if g_out is None else g_out[..., :half]
    d_h = torch.cat([d_ls, d_t], dim=-1)
    d_r = d_h * e
    d_zb = d_r.reshape(-1, c).sum(dim=0)
    d_zlogs = 3.0 * (d_h * h).reshape(-1, c).sum(dim=0)
    return torch.cat([g_a, d_t], dim=-1), d_r, d_zb, d_zlogs


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def _ticket(device: torch.device) -> int:
    """Pointer to the step-mode backward's ticket for the device and its
    current stream: an unsigned int made zero once, before the stream's
    first launch (outside any CUDA-graph capture, where a fill would not run
    until the graph does: capture on a stream that has launched it before)."""
    key = (device.index, torch._C._cuda_getCurrentRawStream(device.index))
    t = _tickets.get(key)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("coupling_step_tail_bwd: call it once on the capturing stream "
                               "outside CUDA-graph capture first, so that its ticket "
                               "counter exists")
        t = torch.zeros((1,), dtype=torch.int32, device=device)
        _tickets[key] = t
    return t.data_ptr()


def _check_shapes(name: str, *tensors: torch.Tensor) -> None:
    shape = tensors[0].shape
    if any(t.shape != shape for t in tensors) or len(shape) < 1:
        raise ValueError(f"{name}: inputs must share one shape [B, ...], got "
                         f"{[tuple(t.shape) for t in tensors]}")


def _ldj_cotangent(name: str, g_ldj: Optional[torch.Tensor], rows: int,
                   device: torch.device) -> Tuple[Optional[int], int]:
    """(pointer, stride) of g_ldj [rows], read in place: an expanded scalar
    (stride 0) or any other stride is not copied."""
    if g_ldj is None:
        return None, 0
    if (tuple(g_ldj.shape) != (rows,) or g_ldj.dtype != torch.float32
            or g_ldj.device != device):
        raise ValueError(f"{name}: g_ldj must be fp32 [{rows}] on {device}, got "
                         f"{g_ldj.dtype} {tuple(g_ldj.shape)} on {g_ldj.device}")
    return g_ldj.data_ptr(), g_ldj.stride(0)


def _check_step(name: str, y: torch.Tensor, r: torch.Tensor, zb: torch.Tensor,
                zlogs: torch.Tensor, ldj: Optional[torch.Tensor]) -> Tuple[int, int, int]:
    """(B, C, pixels an image) of checked step-tail operands."""
    c = y.shape[-1] if y.dim() >= 2 else 0
    if y.dim() < 2 or r.shape != y.shape or c % 2 or c > MAX_STEP_CHANNELS:
        raise ValueError(f"{name}: y and r must share one shape [B, ..., C] with C even "
                         f"and at most {MAX_STEP_CHANNELS}, got {tuple(y.shape)} and "
                         f"{tuple(r.shape)}")
    if zb.shape != (c,) or zlogs.shape != (c,):
        raise ValueError(f"{name}: zb and zlogs must be [{c}], got {tuple(zb.shape)} "
                         f"and {tuple(zlogs.shape)}")
    b = y.shape[0]
    if ldj is not None and ldj.shape != (b,):
        raise ValueError(f"{name}: ldj {tuple(ldj.shape)} != ({b},)")
    return b, c, (y.numel() // (b * c) if b else 0)


def _tail(log_scale: torch.Tensor, bias: torch.Tensor,
          x_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version for CPU tensors, the kernel's plain-operand mode for
    CUDA tensors."""
    if x_b.device.type == "cpu":
        return coupling_tail_plain(log_scale, bias, x_b)
    device = _build.check_cuda_f32("coupling_tail", log_scale, bias, x_b)
    _check_shapes("coupling_tail", log_scale, bias, x_b)
    rows = x_b.shape[0]
    d = x_b.numel() // rows if rows else 0
    y_b = torch.empty_like(x_b)
    ldj = torch.empty((rows,), dtype=torch.float32, device=device)
    vw = vector_width(d, log_scale.data_ptr(), bias.data_ptr(), x_b.data_ptr(), y_b.data_ptr())
    p = forward_plan(rows, d // vw, vw, vw)
    _build.launch("coupling_tail", _build.function("flow_kernels", "coupling_tail_f32"), device,
                  log_scale.data_ptr(), bias.data_ptr(), x_b.data_ptr(), y_b.data_ptr(),
                  ldj.data_ptr(), rows, d, p.vw, p.threads, p.blocks)
    coupling_tail.launches += 1
    return y_b, ldj


def _step_tail(y: torch.Tensor, r: torch.Tensor, zb: torch.Tensor, zlogs: torch.Tensor,
               ldj: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version for CPU tensors, one launch of the kernel's step
    mode for CUDA tensors."""
    if y.device.type == "cpu":
        return coupling_step_tail_plain(y, r, zb, zlogs, ldj)
    device = _build.check_cuda_f32("coupling_step_tail", y, r, zb, zlogs, ldj)
    b, c, px = _check_step("coupling_step_tail", y, r, zb, zlogs, ldj)
    out = torch.empty_like(y)
    ldj_out = torch.empty_like(ldj)
    p = forward_plan(b, px, c // 2, vector_width(c // 2, y.data_ptr(), r.data_ptr(),
                                                 out.data_ptr()))
    _build.launch("coupling_tail", _build.function("flow_kernels", "coupling_tail_step_f32"),
                  device, y.data_ptr(), r.data_ptr(), zb.data_ptr(), zlogs.data_ptr(),
                  ldj.data_ptr(), out.data_ptr(), ldj_out.data_ptr(), b, px, c,
                  p.vw, p.threads, p.blocks)
    coupling_tail.launches += 1
    return out, ldj_out


def coupling_tail_bwd(log_scale: torch.Tensor, bias: torch.Tensor, x_b: torch.Tensor,
                      g_y: Optional[torch.Tensor], g_ldj: Optional[torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tail's vector-Jacobian product in one pass: (d_log_scale, d_x_b)
    for the cotangents g_y [B, ...] and g_ldj [B] (None: zeros; g_ldj may be
    strided); d_bias equals d_x_b.

    CPU tensors take the plain version; CUDA tensors launch the kernel's
    plain-operand mode or raise."""
    if x_b.device.type == "cpu":
        return coupling_tail_bwd_plain(log_scale, bias, x_b, g_y, g_ldj)
    device = _build.check_cuda_f32("coupling_tail_bwd", log_scale, bias, x_b,
                                   *([] if g_y is None else [g_y]))
    _check_shapes("coupling_tail_bwd", log_scale, bias, x_b,
                  *([] if g_y is None else [g_y]))
    rows = x_b.shape[0]
    gl_ptr, gl_stride = _ldj_cotangent("coupling_tail_bwd", g_ldj, rows, device)
    d = x_b.numel() // rows if rows else 0
    d_ls, d_xb = torch.empty_like(x_b), torch.empty_like(x_b)
    gy_ptr = None if g_y is None else g_y.data_ptr()
    vw = vector_width(d, log_scale.data_ptr(), bias.data_ptr(), x_b.data_ptr(),
                      gy_ptr or 0, d_ls.data_ptr(), d_xb.data_ptr())
    p = backward_plan(rows, d // vw, vw, vw)
    _build.launch("coupling_tail_bwd", _build.function("flow_kernels", "coupling_tail_bwd_f32"),
                  device, log_scale.data_ptr(), bias.data_ptr(), x_b.data_ptr(), gy_ptr,
                  gl_ptr, gl_stride, d_ls.data_ptr(), d_xb.data_ptr(), rows, d,
                  p.vw, p.threads, p.blocks, p.px_per_lane)
    coupling_tail_bwd.launches += 1
    return d_ls, d_xb


def coupling_step_tail_bwd(y: torch.Tensor, r: torch.Tensor, zb: torch.Tensor,
                           zlogs: torch.Tensor, g_out: Optional[torch.Tensor],
                           g_ldj: Optional[torch.Tensor]):
    """The step tail's vector-Jacobian product in one launch: (d_y, d_r,
    d_zb, d_zlogs) for the cotangents g_out [B, ..., C] (contiguous) and
    g_ldj [B] (any stride) of (out, ldj'); None counts as zeros.

    CPU tensors take the plain version; CUDA tensors launch the kernel's
    step mode (counted in `coupling_tail_bwd.launches`) or raise."""
    if y.device.type == "cpu":
        return coupling_step_tail_bwd_plain(y, r, zb, zlogs, g_out, g_ldj)
    given = [] if g_out is None else [g_out]
    device = _build.check_cuda_f32("coupling_step_tail_bwd", y, r, zb, zlogs, *given)
    b, c, px = _check_step("coupling_step_tail_bwd", y, r, zb, zlogs, None)
    if g_out is not None and g_out.shape != y.shape:
        raise ValueError(f"coupling_step_tail_bwd: g_out {tuple(g_out.shape)} != "
                         f"{tuple(y.shape)}")
    gl_ptr, gl_stride = _ldj_cotangent("coupling_step_tail_bwd", g_ldj, b, device)
    d_y, d_r = torch.empty_like(y), torch.empty_like(y)
    d_zb, d_zlogs = torch.empty_like(zb), torch.empty_like(zlogs)
    g_ptr = None if g_out is None else g_out.data_ptr()
    p = backward_plan(b, px, c // 2, vector_width(
        c // 2, y.data_ptr(), r.data_ptr(), g_ptr or 0, d_y.data_ptr(), d_r.data_ptr()))
    partial = torch.empty((p.blocks * 2 * c,), dtype=torch.float32, device=device)
    _build.launch("coupling_tail_bwd",
                  _build.function("flow_kernels", "coupling_tail_step_bwd_f32"), device,
                  y.data_ptr(), r.data_ptr(), zb.data_ptr(), zlogs.data_ptr(), g_ptr, gl_ptr,
                  gl_stride, d_y.data_ptr(), d_r.data_ptr(), d_zb.data_ptr(),
                  d_zlogs.data_ptr(), partial.data_ptr(), _ticket(device), b, px, c,
                  p.vw, p.threads, p.blocks, p.px_per_lane)
    coupling_tail_bwd.launches += 1
    return d_y, d_r, d_zb, d_zlogs


# ---------------------------------------------------------------------------
# Differentiable entry points
# ---------------------------------------------------------------------------

class CouplingTailFunction(torch.autograd.Function):
    """coupling_tail with its hand-written gradient. Both passes take the
    kernels on CUDA tensors and the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, log_scale, bias, x_b):
        ctx.save_for_backward(log_scale, bias, x_b)
        ctx.set_materialize_grads(False)  # an unused output's cotangent stays None
        return _tail(log_scale, bias, x_b)

    @staticmethod
    def backward(ctx, g_y, g_ldj):
        if g_y is None and g_ldj is None:
            return None, None, None
        log_scale, bias, x_b = ctx.saved_tensors
        # autograd may hand g_y over as a view (a slice of a concatenation);
        # the kernel takes it contiguous, and g_ldj at any stride
        d_ls, d_xb = coupling_tail_bwd(log_scale, bias, x_b,
                                       None if g_y is None else g_y.contiguous(), g_ldj)
        return d_ls, d_xb, d_xb


class CouplingStepTailFunction(torch.autograd.Function):
    """coupling_step_tail with its hand-written gradient: one kernel launch
    each way on CUDA tensors, the plain versions on CPU tensors. It saves
    y, r, zb and zlogs, what autograd saved for the composition before."""

    @staticmethod
    def forward(ctx, y, r, zb, zlogs, ldj):
        ctx.save_for_backward(y, r, zb, zlogs)
        ctx.set_materialize_grads(False)  # an unused output's cotangent stays None
        return _step_tail(y, r, zb, zlogs, ldj)

    @staticmethod
    def backward(ctx, g_out, g_ldj):
        if g_out is None and g_ldj is None:
            return None, None, None, None, None
        y, r, zb, zlogs = ctx.saved_tensors
        d_y, d_r, d_zb, d_zlogs = coupling_step_tail_bwd(
            y, r, zb, zlogs, None if g_out is None else g_out.contiguous(), g_ldj)
        return d_y, d_r, d_zb, d_zlogs, g_ldj


def coupling_tail(log_scale: torch.Tensor, bias: torch.Tensor,
                  x_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W, C/2] fp32 inputs -> (y_b [B, H, W, C/2], ldj [B]).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises. Differentiable in all three arguments (CouplingTailFunction);
    where no gradient is asked for, nothing is saved."""
    if torch.is_grad_enabled() and (log_scale.requires_grad or bias.requires_grad
                                    or x_b.requires_grad):
        return CouplingTailFunction.apply(log_scale, bias, x_b)
    return _tail(log_scale, bias, x_b)


def coupling_step_tail(y: torch.Tensor, r: torch.Tensor, zb: torch.Tensor,
                       zlogs: torch.Tensor, ldj: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tail of a Glow step: y [B, H, W, C] (the channel mix's output),
    r [B, H, W, C] (the zeroconv's raw convolution, contiguous NHWC), zb and
    zlogs [C] (its bias and log-scale), ldj [B] -> (out [B, H, W, C], ldj
    plus the tail's logdet), fp32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (counted in `coupling_tail.launches`) or raises. Differentiable in all
    five arguments (CouplingStepTailFunction); where no gradient is asked
    for, nothing is saved."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (y, r, zb, zlogs, ldj)):
        return CouplingStepTailFunction.apply(y, r, zb, zlogs, ldj)
    return _step_tail(y, r, zb, zlogs, ldj)


_INVERSE_NO_GRADIENT = ("the inverse tail is not differentiated in the JAX package "
                        "either; use coupling_tail_inverse_plain")


def coupling_tail_inverse(log_scale: torch.Tensor, bias: torch.Tensor,
                          y_b: torch.Tensor) -> torch.Tensor:
    """Inverse tail, [B, H, W, C/2] fp32 inputs -> x_b of the same shape.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel's
    plain-operand mode or raises. Not differentiable: raises where a
    gradient is asked for."""
    _build.refuse_gradient("coupling_tail_inverse", _INVERSE_NO_GRADIENT, log_scale, bias, y_b)
    if y_b.device.type == "cpu":
        return coupling_tail_inverse_plain(log_scale, bias, y_b)
    device = _build.check_cuda_f32("coupling_tail_inverse", log_scale, bias, y_b)
    _check_shapes("coupling_tail_inverse", log_scale, bias, y_b)
    x_b = torch.empty_like(y_b)
    n = y_b.numel()
    vw = vector_width(n, log_scale.data_ptr(), bias.data_ptr(), y_b.data_ptr(), x_b.data_ptr())
    p = inverse_plan(1, n // vw, vw, vw)
    _build.launch("coupling_tail_inverse",
                  _build.function("flow_kernels", "coupling_tail_inverse_f32"), device,
                  log_scale.data_ptr(), bias.data_ptr(), y_b.data_ptr(), x_b.data_ptr(), n,
                  p.vw, p.threads, p.blocks)
    coupling_tail_inverse.launches += 1
    return x_b


def coupling_step_tail_inverse(y: torch.Tensor, r: torch.Tensor, zb: torch.Tensor,
                               zlogs: torch.Tensor) -> torch.Tensor:
    """The tail of an inverse Glow step: y [B, H, W, C] (the step's output),
    r [B, H, W, C] (the zeroconv's raw convolution of y's first half,
    contiguous NHWC), zb and zlogs [C] (its bias and log-scale) -> x [B, H,
    W, C], the inverse channel mix's input, fp32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (counted in `coupling_tail_inverse.launches`) or raises. Not
    differentiable: raises where a gradient is asked for."""
    _build.refuse_gradient("coupling_step_tail_inverse", _INVERSE_NO_GRADIENT, y, r, zb, zlogs)
    if y.device.type == "cpu":
        return coupling_step_tail_inverse_plain(y, r, zb, zlogs)
    device = _build.check_cuda_f32("coupling_step_tail_inverse", y, r, zb, zlogs)
    b, c, px = _check_step("coupling_step_tail_inverse", y, r, zb, zlogs, None)
    x = torch.empty_like(y)
    p = inverse_plan(b, px, c // 2, vector_width(c // 2, y.data_ptr(), r.data_ptr(),
                                                 x.data_ptr()))
    _build.launch("coupling_step_tail_inverse",
                  _build.function("flow_kernels", "coupling_tail_inverse_step_f32"), device,
                  y.data_ptr(), r.data_ptr(), zb.data_ptr(), zlogs.data_ptr(), x.data_ptr(),
                  b, px, c, p.vw, p.threads, p.blocks)
    coupling_tail_inverse.launches += 1
    return x


# `coupling_tail.launches` counts every launch of the forward kernel, both
# modes; `coupling_tail_bwd.launches` every launch of the backward kernel;
# `coupling_tail_inverse.launches` every launch of the inverse kernel, both
# modes.
coupling_tail.launches = 0
coupling_tail_bwd.launches = 0
coupling_tail_inverse.launches = 0
