"""Low-level ops: activation registry, window index math, kernels."""
