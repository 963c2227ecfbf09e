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
models     : Glow and its Gaussian prior.
convert    : weight bridge from the JAX package's parameter trees, and the
             .npz weight format.
inference  : bits/dim scoring and sampling (the serving path).
serve      : HTTP generation server for a Glow model.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is wanted but absent; never falls back."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def disable_tf32() -> None:
    """Full fp32 in cuDNN convolutions and cuBLAS matmuls. cuDNN runs fp32
    convolutions in TF32 by default, which keeps about three decimal digits
    and breaks fp32 parity with the JAX package."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
