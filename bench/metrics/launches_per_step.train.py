"""Device kernels launched per training step: the kernel rows of the
traced window over its steps."""


def read(trace):
    if trace.kind != "train" or not trace.kernels:
        return None
    return len(trace.kernels) / trace.steps
