"""Mixture-of-Experts FFN: top-k routing with grouped, capacity-bounded
einsum dispatch (the port of ``repro/models/moe.py``).

Tokens are routed in groups of ``moe_group_size``; each expert admits at
most ``capacity`` tokens of a group, in the reference's priority order (all
first choices before any second choice, each choice in token order), and
drops the rest.  Which tokens are dropped is part of the result, so the
routing follows the reference step by step: the router in float32, top-k
ties broken towards the lower expert index (``jax.lax.top_k``'s order), the
weights renormalised with a 1e-9 floor, the same Python capacity
arithmetic, pad tokens kept out of capacity, and ``dispatch``/``combine``
cast to the compute dtype before the expert products.

The dispatch is dense, as in the reference: every expert's weights are
read for every group, whether or not a token was routed to it.  The
reference's sharding hints (``constrain``) have no numeric effect and are
not carried over.

Under a data-parallel split (a meshed train step hands each rank its rows
of the global batch, with ``dp_groups``) the reference's quantities over
the global batch are kept: the group size comes from the global token
count, each rank's tokens must make whole groups (else a group would span
ranks, and the call raises), and the aux loss's two means are all-reduced,
differentiably, before their product.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.cfa.api import resolve_device
from repro_torch.distributed.sharding import P

from .config import ArchConfig
from .layers import _cd, _normal, _param, silu

__all__ = ["MoE", "init_moe", "spec_moe", "moe", "top_k"]


class MoE(nn.Module):
    """Router (d, E) in float32; expert weights w1/w3 (E, d, f) and w2
    (E, f, d) in ``dtype`` (default: the compute dtype)."""

    def __init__(self, cfg: ArchConfig, *, device="cuda", generator=None, dtype=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.moe_experts
        cd = dtype or _cd(cfg)
        self.router = _param(torch.zeros((d, e), device=device))
        self.w1 = _param(torch.zeros((e, d, f), dtype=cd, device=device))
        self.w3 = _param(torch.zeros((e, d, f), dtype=cd, device=device))
        self.w2 = _param(torch.zeros((e, f, d), dtype=cd, device=device))
        if generator is not None:
            with torch.no_grad():
                dev = self.router.device
                self.router.copy_(_normal((d, e), d ** -0.5, torch.float32, generator, dev))
                self.w1.copy_(_normal((e, d, f), d ** -0.5, cd, generator, dev))
                self.w3.copy_(_normal((e, d, f), d ** -0.5, cd, generator, dev))
                self.w2.copy_(_normal((e, f, d), f ** -0.5, cd, generator, dev))


def init_moe(cfg: ArchConfig, *, generator: torch.Generator | None = None,
             device="cuda", dtype=None) -> MoE:
    """An MoE layer (the reference's ``init_moe``): weights drawn from
    ``generator``, or zeros to be loaded when it is None; on ``device``, the
    CUDA device unless the caller asks for the CPU (a missing card raises)."""
    return MoE(cfg, device=device, generator=generator, dtype=dtype)


def spec_moe() -> dict:
    """The reference's logical specs: experts over 'model' (EP), the d_model
    dim FSDP over 'data'."""
    return {
        "router": P("data", None),
        "w1": P("model", "data", None),
        "w3": P("model", "data", None),
        "w2": P("model", None, "data"),
    }


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of the last axis and their indices, largest
    first and, among equal values, the lower index first (``jax.lax.top_k``'s
    order; ``torch.topk`` does not promise one)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _mean_over(t: torch.Tensor, dp_groups, n: int) -> torch.Tensor:
    """The mean of ``t`` over the ranks of ``dp_groups`` (``n`` in all); its
    gradient is all-reduced too."""
    from torch.distributed.nn.functional import all_reduce

    for g in dp_groups:
        t = all_reduce(t, group=g)
    return t / n


def moe(m: MoE, x: torch.Tensor, dp_groups=()) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, d) in the compute dtype, load-balance aux loss
    (float32 scalar)).  ``dp_groups``: the process groups over which the
    batch is split (none: ``x`` is the whole batch)."""
    cfg = m.cfg
    B, S, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    cd = _cd(cfg)
    T = B * S
    n_dp = math.prod(g.size() for g in dp_groups)
    gs = min(cfg.moe_group_size, T * n_dp)  # over the global batch's tokens
    if n_dp > 1 and T % gs:
        raise ValueError(f"a rank's {T} tokens do not make whole routing groups of {gs} "
                         f"(the global batch's {T * n_dp}): a group would span ranks")
    pad = (-T) % gs
    xt = x.reshape(T, d)
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    G = xt.shape[0] // gs
    xg = xt.reshape(G, gs, d)
    # padded tokens must not eat expert capacity
    valid = (torch.arange(G * gs, device=x.device) < T).float().reshape(G, gs)

    logits = xg.float() @ m.router  # (G, gs, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = top_k(probs, k)  # (G, gs, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    cap = max(1, int(gs * k * cfg.moe_capacity_factor / e))
    cap = -(-cap // 4) * 4  # the reference pads capacity for lane alignment
    slots = torch.arange(cap, device=x.device)

    counts = torch.zeros((G, 1, e), device=x.device)
    dispatch = combine = None
    for j in range(k):  # k is small and static: unrolled priority assignment
        oh = F.one_hot(top_idx[..., j], e).float() * valid[..., None]  # (G, gs, E)
        pos = counts + torch.cumsum(oh, dim=1) - oh  # position if admitted
        admitted = (pos < cap).float() * oh
        counts = counts + oh.sum(dim=1, keepdim=True)
        # one_hot(pos, cap) with a zero row for pos >= cap (over capacity)
        slot = (pos.long()[..., None] == slots).float()  # (G, gs, E, C)
        disp_j = admitted[..., None] * slot
        comb_j = disp_j * top_w[..., j][..., None, None]
        dispatch = disp_j if dispatch is None else dispatch + disp_j
        combine = comb_j if combine is None else combine + comb_j

    dispatch, combine = dispatch.to(cd), combine.to(cd)
    # expert-facet buffers: one contiguous block of admitted tokens per expert
    ein = torch.einsum("gsec,gsd->gecd", dispatch, xg.to(cd))
    h = silu(torch.einsum("gecd,edf->gecf", ein, m.w1.to(cd)))
    h = h * torch.einsum("gecd,edf->gecf", ein, m.w3.to(cd))
    eout = torch.einsum("gecf,efd->gecd", h, m.w2.to(cd))
    out = torch.einsum("gsec,gecd->gsd", combine, eout)
    out = out.reshape(G * gs, d)[:T].reshape(B, S, d)

    # Switch-style load-balance loss: E * sum_e f_e * p_e
    frac_tokens = F.one_hot(top_idx[..., 0], e).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    if n_dp > 1:
        frac_tokens = _mean_over(frac_tokens, dp_groups, n_dp)
        frac_probs = _mean_over(frac_probs, dp_groups, n_dp)
    aux = e * torch.sum(frac_tokens * frac_probs)
    return out, aux
