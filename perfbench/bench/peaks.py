"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

FP32_FLOPS = 67e12    # fp32 outside the tensor cores
TF32_FLOPS = 495e12   # TF32 on the tensor cores
FP32_EMULATED_FLOPS = TF32_FLOPS / 3  # fp32-accurate products as three TF32 ones (3xTF32)
HBM_BYTES = 3.35e12   # device memory bandwidth, bytes/s


def least_seconds(nbytes: float, ops: float):
    """The least time of work of `nbytes` and fp32-accurate `ops`: bytes
    over the memory bandwidth or operations over the fastest fp32-accurate
    rate (3xTF32 on the tensor cores), the larger, and which one bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES, ops / FP32_EMULATED_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
