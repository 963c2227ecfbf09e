"""nfdpm_tpu_torch — the PyTorch/CUDA port of nfdpm_tpu for NVIDIA Hopper.

The JAX package `nfdpm_tpu` is the reference; this package mirrors its
layout (ops/, models/) and its NHWC layout at every public function, and
imports neither JAX nor anything of `nfdpm_tpu`. The TPU's Pallas kernels
become hand-written CUDA kernels under ops/kernels/, each with a plain
PyTorch version beside it.

Subpackages and modules
-----------------------
ops        : quantization, zeroconv, the coupling CNN, Glow bijectors and
             the CUDA kernels (ops/kernels/).
models     : Glow and its Gaussian prior; the stage-2 diffusion prior (UNet,
             Gaussian diffusion, formaters, the per-part prior, the flow as
             its backbone).
convert    : weight bridge from the JAX package's parameter trees (Glow and
             flax UNet), and the .npz weight format.
inference  : bits/dim scoring and sampling of both kinds (the serving path).
training   : both stages' training: optimizer (value and norm clips,
             Adam/AdamW), train and eval steps, the training loops with
             mid-epoch resume, checkpoints, tracking; runload rebuilds a
             model from a run directory.
data       : dataset readers and the batch pipeline (numpy on the host).
utils      : YAML configuration with dotted overrides, logging, seeding;
             the hung-step watchdog and the trainers' profiler hook; the
             original PyTorch repository's Glow and UNet state dicts into
             the port's trees, and the Glow's back out.
run_baseline, run_diffusion_prior : the entry points over
             configs/nf_base.yaml and configs/nf_diffusion.yaml.
serve      : HTTP generation server for a Glow model or a Glow with a
             diffusion prior, from weights or a run directory.
generate_samples, interpolate : sample and interpolation commands over a
             run directory.
convert_reference_checkpoint, export_reference_checkpoint : a checkpoint of
             the original PyTorch repository into a run directory, and a
             stage-1 run directory back into one.
profiling  : device time by kernel of a call, through torch.profiler.
parallel   : data parallelism across processes and GPUs (torchrun), ZeRO
             partitioning of the Adam moments, part-parallel stage 2.
"""

from __future__ import annotations

import functools

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is wanted but absent; never falls back. CUDA
    without an index is the current device, cuda:LOCAL_RANK in a
    data-parallel launch (parallel/distributed.py sets it first)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def disable_tf32() -> None:
    """Full fp32 in cuDNN convolutions and cuBLAS matmuls. cuDNN runs fp32
    convolutions in TF32 by default, which keeps about three decimal digits
    and breaks fp32 parity with the JAX package."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


# model.training.matmul_precision of the running entry point (the JAX
# package's jax_default_matmul_precision): None, "default" and "highest"
# keep cuDNN and cuBLAS in full fp32, the port's parity setting (the JAX
# package's CPU reference computes fp32 for all three); "high" lets them
# run fp32 work in TF32. The hand-written kernels take no part: their
# tensor-core products stay 3xTF32 whatever it is.
MATMUL_PRECISIONS = {None: False, "default": False, "highest": False, "high": True}
_matmul_precision = None


def set_matmul_precision(value=None) -> None:
    """Set the process's matmul precision and apply it; ValueError for a
    value other than those of MATMUL_PRECISIONS."""
    global _matmul_precision
    if value not in MATMUL_PRECISIONS:
        raise ValueError(f"model.training.matmul_precision must be one of 'default', "
                         f"'high', 'highest' or unset, got {value!r}")
    _matmul_precision = value
    apply_matmul_precision()


def matmul_precision():
    return _matmul_precision


def apply_matmul_precision() -> None:
    """TF32 in cuDNN and cuBLAS as the process's matmul precision says
    (off unless it is "high"): what the model paths call where they start."""
    tf32 = MATMUL_PRECISIONS[_matmul_precision]
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32


def in_full_fp32(fn):
    """fn with TF32 off (disable_tf32), the switches restored after it."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        disable_tf32()
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before

    return wrapper
