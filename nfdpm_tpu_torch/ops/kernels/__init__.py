"""Hand-written CUDA kernels for Hopper (csrc/), their wrappers and their
plain PyTorch versions. Counterpart of nfdpm_tpu/ops/pallas/."""

from .step_megakernel import step_megakernel_forward, step_megakernel_forward_plain

__all__ = ["step_megakernel_forward", "step_megakernel_forward_plain"]
