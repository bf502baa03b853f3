"""The share of a training step in which no operation runs on the device:
100 times (1 - the device's busy time per traced step, the union of its
operations' intervals, over the host time per step of the chunks run just
before without the profiler, which slows the host and so lengthens the
traced window)."""


def read(trace):
    if trace.kind != "train" or not trace.device_ops or trace.plain_steps == 0:
        return None
    return 100.0 * (1.0 - (trace.busy_s() / trace.steps) / (trace.plain_s / trace.plain_steps))
