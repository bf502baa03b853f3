"""The allocator's peak over the traced window (``max_memory_allocated``
after ``reset_peak_memory_stats`` at its start), in GiB."""


def read(trace):
    if trace.kind != "train" or not trace.peak_bytes:
        return None
    return trace.peak_bytes / 2 ** 30
