"""Device milliseconds per training step in matrix-product kernels
(cuBLAS, CUTLASS, nvjet) by the frozen name table."""


def read(trace):
    if trace.kind != "train" or not trace.kernels:
        return None
    return trace.class_us("gemm") / 1e3 / trace.steps
