"""Device milliseconds per training step in kernels that the frozen name
table (``bench/counts/kernel_classes.json``) classes as elementwise or
reduction: the model's eager PyTorch, the loss and the optimizer."""


def read(trace):
    if trace.kind != "train" or not trace.kernels:
        return None
    return trace.class_us("elementwise") / 1e3 / trace.steps
