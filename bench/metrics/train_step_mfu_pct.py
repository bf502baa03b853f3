"""The whole training step's share of the card's bf16 peak: model FLOPs
per step (``bench/counts/flops.py``: 6 N per token, attention's score and
value products, the SSD's chunk products; no recomputation) times the steps
of the chunk run without the profiler, over 989 TFLOP/s times that chunk's
host-clock length."""
from bench.counts import flops


def read(trace):
    if trace.kind != "train" or trace.plain_steps == 0:
        return None
    total = flops.model_flops_per_step(trace.arch, trace.batch, trace.seq) * trace.plain_steps
    return 100.0 * total / (flops.PEAK_BF16_FLOPS * trace.plain_s)
