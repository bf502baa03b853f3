"""``ssd_scan``'s share of its roofline in a training step: the least time
its call could take (``bench/counts/flops.py``: max(FLOPs at the peak of
its inputs' type, bytes at 3.35 TB/s), the per-chunk states written as the
training route does) over its device time per call.  Every call of a
training step has the cell's shapes: (batch, seq) rows, the
configuration's heads, head size, state and chunk."""
from bench.counts import flops


def read(trace):
    calls = [k for k in trace.kernels if "ssd_scan_mma_kernel" in k.name
             or "ssd_scan_fma_kernel" in k.name]
    if trace.kind != "train" or not calls:
        return None
    a = trace.arch
    esize = 2 if "mma" in calls[0].name else 4
    din = a["ssm_expand"] * a["d_model"]
    shape = (trace.batch, trace.seq, din // a["ssm_head_dim"], a["ssm_head_dim"],
             a["ssm_state"], min(a["ssm_chunk"], trace.seq))
    bound = flops.bound_s(*flops.ssd_scan_counts(*shape, esize, states=True), esize)
    per_call = sum(k.dur_us for k in calls) / 1e6 / len(calls)
    return 100.0 * bound / per_call
