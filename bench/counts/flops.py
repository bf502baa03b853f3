"""Frozen operation and byte counts: the yardstick of the rooflines and of
the whole step's share of the peak.  Copied from ``chip_smoke.py``'s bound
arithmetic (``_ssd_bound``, ``_ssd_bwd_bound``) and ``ArchConfig``'s
parameter counts, and never imported from the program, so that a change to
the program cannot move its own yardstick.

Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet; dense,
no sparsity).
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12

__all__ = ["PEAK_BYTES_PER_S", "PEAK_BF16_FLOPS", "PEAK_F32_FLOPS", "matmul_params",
           "model_flops_per_step", "ssd_scan_counts", "ssd_scan_bwd_counts", "bound_s"]


def _expert_ff(arch: dict) -> int:
    return arch["moe_d_ff"] or arch["d_ff"]


def _moe_products(arch: dict) -> int | float:
    """One MoE layer's weights a token multiplies through: the router's
    ``d × moe_experts``; the routed experts' ``3 d f`` times the experts a
    token meets on this card, ``moe_top_k × held / moe_experts``, the
    expected share under uniform routing (``moe_experts_held``: the experts
    this card holds of an expert-parallel layer, 0 for all of them); and a
    shared expert's ``3 d × moe_shared_d_ff``, which every token passes."""
    d, e = arch["d_model"], arch["moe_experts"]
    routed = arch["moe_top_k"] * (arch.get("moe_experts_held", 0) or e) * 3 * d * _expert_ff(arch)
    whole, rest = divmod(routed, e)
    return d * e + (routed / e if rest else whole) + 3 * d * arch.get("moe_shared_d_ff", 0)


def matmul_params(arch: dict) -> int | float:
    """N: the weights a token multiplies through in the forward pass — every
    layer's projections, the experts a token is routed to on this card
    (:func:`_moe_products`; no capacity padding), the router and the output
    head; not the embedding lookup, norms, convolutions or per-head scalars
    (with every expert held and no shared expert, ``ArchConfig``'s
    ``active_param_count()`` less the embedding table).  A whole number
    unless an expert share makes the routed part a fraction."""
    d, v = arch["d_model"], arch["vocab"]
    n_per = arch["n_layers"] // len(arch["period"])
    per_period = 0
    for i, kind in enumerate(arch["period"]):
        if kind == "attn":
            per_period += 2 * d * arch["n_heads"] * arch["head_dim"]
            per_period += 2 * d * arch["n_kv_heads"] * arch["head_dim"]
        elif kind == "mamba":
            din = arch["ssm_expand"] * d
            h = din // arch["ssm_head_dim"]
            per_period += 2 * d * din + 2 * d * arch["ssm_state"] + d * h + din * d
        else:
            raise ValueError(kind)
        if i in arch["moe_positions"]:
            per_period += _moe_products(arch)
        elif not (kind == "mamba" and arch["family"] == "ssm"):
            per_period += 3 * d * arch["d_ff"]
    return v * d + n_per * per_period


def _ssd_flops(B: int, T: int, H: int, P: int, N: int, L: int) -> int:
    """The forward chunk products of one SSD call: per chunk 2 L^2 N (C B^T)
    and per head and chunk 2 L^2 P (the masked decay matrix times x) + 4 L P N
    (the chunk's state and its read-out)."""
    return B * (T // L) * (2 * L * L * N + H * (2 * L * L * P + 4 * L * P * N))


def model_flops_per_step(arch: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 N per token, plus attention's
    score and value products (12 L H Q T per token, PaLM appendix B) and the
    SSD's chunk products (once forward, twice backward); no recomputation."""
    tokens = batch * seq
    flops = 6 * matmul_params(arch) * tokens
    n_per = arch["n_layers"] // len(arch["period"])
    for kind in arch["period"]:
        if kind == "attn":
            flops += 12 * n_per * arch["n_heads"] * arch["head_dim"] * seq * tokens
        elif kind == "mamba":
            din = arch["ssm_expand"] * arch["d_model"]
            H, P = din // arch["ssm_head_dim"], arch["ssm_head_dim"]
            flops += 3 * n_per * _ssd_flops(batch, seq, H, P, arch["ssm_state"],
                                            min(arch["ssm_chunk"], seq))
    return float(flops)


def ssd_scan_counts(B: int, T: int, H: int, P: int, N: int, L: int, esize: int,
                    states: bool) -> tuple[int, int]:
    """(FLOPs, bytes) of one ``ssd_scan`` call: x, loga, B and C read once,
    y and the final state written once, and with ``states`` (the training
    route) the state entering every chunk, (B, T/L, H, P, N) float32."""
    nbytes = (2 * B * T * H * P + 2 * B * T * N) * esize + B * T * H * 4 + B * H * P * N * 4
    if states:
        nbytes += B * (T // L) * H * P * N * 4
    return _ssd_flops(B, T, H, P, N, L), nbytes


def ssd_scan_bwd_counts(B: int, T: int, H: int, P: int, N: int, L: int,
                        esize: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one ``ssd_scan_bwd`` call (its four launches): x,
    dy, the saved states, loga, B and C read once; dx, dloga, dB and dC
    written once; per chunk 2 L^2 N (G) + 4 L^2 N (dG B, dG^T C), per head
    and chunk 4 L^2 P (dy x^T, W^T dy) + 8 L P N (dS, the facet term, dy^T S,
    x^T dS)."""
    nc = T // L
    nbytes = (3 * B * T * H * P + 4 * B * T * N) * esize + B * nc * H * P * N * 4 \
        + 2 * B * T * H * 4
    flops = B * nc * (6 * L * L * N + H * (4 * L * L * P + 8 * L * P * N))
    return flops, nbytes


def bound_s(flops: int, nbytes: int, esize: int) -> float:
    """The least time the card could take: operations at the peak of the
    inputs' type (bf16 tensor cores for 2-byte inputs, FP32 otherwise) or
    bytes at the memory peak, whichever is longer."""
    peak = PEAK_BF16_FLOPS if esize == 2 else PEAK_F32_FLOPS
    return max(flops / peak, nbytes / PEAK_BYTES_PER_S)
