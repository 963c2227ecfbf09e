"""Hand-written CUDA kernels for Hopper (csrc/), their wrappers and their
plain PyTorch versions. Counterpart of nfdpm_tpu/ops/pallas/."""
