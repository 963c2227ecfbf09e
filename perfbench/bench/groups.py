"""Device kernels grouped by name: a frozen copy of the groups of
nfdpm_tpu_torch/profiling.py (GROUPS, first match wins), so that a change to
the program cannot move what a per-layer metric counts."""

GROUPS = (
    ("fused_linear_attention", ("fla_fused_kernel", "fla_ctx_pass_kernel",
                                "fla_out_pass_kernel")),
    ("fused_linear_attention backward", ("fla_bwd_",)),
    ("channel_mix + coupling tails", ("channel_mix_", "coupling_tail")),
    ("convolution backward (cuDNN)", ("wgrad", "dgrad", "bwd_data", "bwd_filter",
                                      "backward_data", "backward_filter")),
    ("optimizer and clips (foreach)", ("multi_tensor_apply",)),
    ("convolution (cuDNN)", ("conv", "xmma", "implicit_gemm", "winograd", "fft",
                             "nchwToNhwc", "nhwcToNchw", "cudnn")),
    ("matmul (cuBLAS)", ("gemm", "gemv", "cublas", "trsm", "splitKreduce")),
    ("group norm", ("group_norm", "GroupNorm")),
    ("reduction", ("reduce_kernel", "softmax")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "index_elementwise",
                     "CatArrayBatched", "upsample")),
    ("copy / fill", ("copy", "fill", "Memcpy", "Memset")),
)

CONVOLUTION = ("convolution (cuDNN)", "convolution backward (cuDNN)")


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"
