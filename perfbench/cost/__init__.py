"""Operations and bytes of each layer's work, counted from the shapes of
the configuration and the traffic, not from the kernels that run it."""
