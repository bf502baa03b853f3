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

A layer may hold a share of the experts, as one rank of an expert-parallel
group does (``moe_experts_held`` of the router's ``moe_experts``, from
``first_expert``): it routes every token over all the experts, with the
capacity the whole layer's, and computes only its own experts' part of the
output; its dispatch and combine span only those experts.  Nothing stands
in for the other ranks' experts: the sum of every rank's output is the
whole layer's.  The aux loss is over all the experts.  A shared expert
(``moe_shared_d_ff``), a SwiGLU, adds its output for every token.

Under an installed recorder a call records ``moe.dispatch``
(the routing, from the router's logits through the capacity loop to the
expert buffers), ``moe.combine`` (the combine product and the aux loss) and
``moe.shared`` (the shared expert and its add); the experts' three products
lie between the first two, in neither.  A remat recompute records them
again, on the thread autograd runs it on.  Each call adds to the
recorder's counters ``moe.slots`` (its tokens' token-choice pairs),
``moe.slots_held`` (those routed to the experts it holds) and
``moe.dropped_held`` (those past an expert's capacity), the last two as
device tensors that become numbers when the counters are read: nothing
synchronizes inside the step.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import runtime
from repro_torch.distributed.sharding import P
from repro_torch.runtime import resolve_device

from .config import ArchConfig
from .layers import MLP, _cd, _normal, _param, mlp, silu, spec_mlp

__all__ = ["MoE", "init_moe", "spec_moe", "moe", "top_k"]


class MoE(nn.Module):
    """Router (d, E) in float32; the held experts' weights w1/w3 (held, d,
    f) and w2 (held, f, d) in ``dtype`` (default: the compute dtype), expert
    ``first_expert + i`` at index i; a shared expert ``shared`` (an ``MLP``
    of width ``moe_shared_d_ff``) where the configuration has one."""

    def __init__(self, cfg: ArchConfig, *, device="cuda", generator=None, dtype=None,
                 first_expert: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.experts_held
        if not 0 <= first_expert <= cfg.moe_experts - e:
            raise ValueError(f"experts {first_expert}..{first_expert + e - 1} of "
                             f"{cfg.moe_experts}")
        self.first_expert = first_expert
        cd = dtype or _cd(cfg)
        self.router = _param(torch.zeros((d, cfg.moe_experts), device=device))
        self.w1 = _param(torch.zeros((e, d, f), dtype=cd, device=device))
        self.w3 = _param(torch.zeros((e, d, f), dtype=cd, device=device))
        self.w2 = _param(torch.zeros((e, f, d), dtype=cd, device=device))
        if generator is not None:
            with torch.no_grad():
                dev = self.router.device
                self.router.copy_(_normal((d, cfg.moe_experts), d ** -0.5, torch.float32,
                                          generator, dev))
                self.w1.copy_(_normal((e, d, f), d ** -0.5, cd, generator, dev))
                self.w3.copy_(_normal((e, d, f), d ** -0.5, cd, generator, dev))
                self.w2.copy_(_normal((e, f, d), f ** -0.5, cd, generator, dev))
        if cfg.moe_shared_d_ff:
            self.shared = MLP(cfg, cfg.moe_shared_d_ff, device=device, generator=generator,
                              dtype=dtype)


def init_moe(cfg: ArchConfig, *, generator: torch.Generator | None = None,
             device="cuda", dtype=None, first_expert: int = 0) -> MoE:
    """An MoE layer (the reference's ``init_moe``): weights drawn from
    ``generator``, or zeros to be loaded when it is None; on ``device``, the
    CUDA device unless the caller asks for the CPU (a missing card raises);
    of a share, the experts from ``first_expert``."""
    return MoE(cfg, device=device, generator=generator, dtype=dtype, first_expert=first_expert)


def spec_moe(cfg: ArchConfig | None = None) -> dict:
    """The reference's logical specs: experts over 'model' (EP), the d_model
    dim FSDP over 'data'; a shared expert as an MLP."""
    s = {
        "router": P("data", None),
        "w1": P("model", "data", None),
        "w3": P("model", "data", None),
        "w2": P("model", None, "data"),
    }
    if cfg is not None and cfg.moe_shared_d_ff:
        s["shared"] = spec_mlp()
    return s


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
    held, first = cfg.experts_held, m.first_expert
    cd = _cd(cfg)
    T = B * S
    n_dp = math.prod(g.size() for g in dp_groups)
    gs = min(cfg.moe_group_size, T * n_dp)  # over the global batch's tokens
    if n_dp > 1 and T % gs:
        raise ValueError(f"a rank's {T} tokens do not make whole routing groups of {gs} "
                         f"(the global batch's {T * n_dp}): a group would span ranks")
    rec = runtime.active()
    with runtime.train_span(rec, "moe.dispatch"):
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

        # the held experts' queues alone: an expert's positions count only
        # the tokens routed to it, so the other experts' need not be built
        # (a whole layer holds them all, from 0).  Every choice's one-hot over
        # them at once: a token routed elsewhere, or a pad, has a zero row
        held_ids = torch.arange(first, first + held, device=x.device)
        ohs = (top_idx[..., None] == held_ids) * valid[..., None, None]  # (G, gs, k, held)
        counts = torch.zeros((G, 1, held), device=x.device)
        dispatch = combine = None
        for j in range(k):  # k is small and static: unrolled priority assignment
            oh = ohs[:, :, j]
            pos = counts + torch.cumsum(oh, dim=1) - oh  # position if admitted
            admitted = (pos < cap).float() * oh
            counts = counts + oh.sum(dim=1, keepdim=True)
            # one_hot(pos, cap) with a zero row for pos >= cap (over capacity)
            slot = (pos.long()[..., None] == slots).float()  # (G, gs, held, C)
            disp_j = admitted[..., None] * slot
            comb_j = disp_j * top_w[..., j][..., None, None]
            dispatch = disp_j if dispatch is None else dispatch + disp_j
            combine = comb_j if combine is None else combine + comb_j
        if rec is not None:
            slots_held = counts.sum()
            rec.counters.add("moe.slots", T * k)
            rec.counters.add_device("moe.slots_held", slots_held)
            rec.counters.add_device("moe.dropped_held", slots_held - dispatch.sum())

        dispatch, combine = dispatch.to(cd), combine.to(cd)
        # expert-facet buffers: one contiguous block of admitted tokens per expert
        ein = torch.einsum("gsec,gsd->gecd", dispatch, xg.to(cd))
    h = silu(torch.einsum("gecd,edf->gecf", ein, m.w1.to(cd)))
    h = h * torch.einsum("gecd,edf->gecf", ein, m.w3.to(cd))
    eout = torch.einsum("gecf,efd->gecd", h, m.w2.to(cd))
    with runtime.train_span(rec, "moe.combine"):
        out = torch.einsum("gsec,gecd->gsd", combine, eout)
        out = out.reshape(G * gs, d)[:T].reshape(B, S, d)

        # Switch-style load-balance loss: E * sum_e f_e * p_e
        frac_tokens = F.one_hot(top_idx[..., 0], e).float().mean(dim=(0, 1))
        frac_probs = probs.mean(dim=(0, 1))
        if n_dp > 1:
            frac_tokens = _mean_over(frac_tokens, dp_groups, n_dp)
            frac_probs = _mean_over(frac_probs, dp_groups, n_dp)
        aux = e * torch.sum(frac_tokens * frac_probs)
    if cfg.moe_shared_d_ff:
        with runtime.train_span(rec, "moe.shared"):
            out = out + mlp(m.shared, x)
    return out, aux
