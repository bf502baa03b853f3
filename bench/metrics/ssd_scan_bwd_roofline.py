"""``ssd_scan_bwd``'s share of its roofline in a training step: the least
time of one call (``bench/counts/flops.py``) over the device time of one
call, its four launches (``local``, ``pass``, ``head``, ``cross``) summed;
calls are counted by their one ``pass_kernel`` launch."""
import re

from bench.counts import flops

_LAUNCHES = re.compile(r"\b(local_(mma|fma)|pass_kernel|head_(mma|fma)|cross_(mma|fma))\b")


def read(trace):
    parts = [k for k in trace.kernels if _LAUNCHES.search(k.name)]
    calls = sum(1 for k in parts if re.search(r"\bpass_kernel\b", k.name))
    if trace.kind != "train" or calls == 0:
        return None
    a = trace.arch
    esize = 2 if any("_mma" in k.name for k in parts) else 4
    din = a["ssm_expand"] * a["d_model"]
    shape = (trace.batch, trace.seq, din // a["ssm_head_dim"], a["ssm_head_dim"],
             a["ssm_state"], min(a["ssm_chunk"], trace.seq))
    bound = flops.bound_s(*flops.ssd_scan_bwd_counts(*shape, esize), esize)
    per_call = sum(k.dur_us for k in parts) / 1e6 / calls
    return 100.0 * bound / per_call
