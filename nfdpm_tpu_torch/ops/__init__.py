"""Flow primitives: quantization, zeroconv, coupling CNN, bijectors, kernels."""
