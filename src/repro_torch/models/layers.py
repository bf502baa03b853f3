"""Core model layers in PyTorch: norms, RoPE, GQA attention (prefill and
decode over the facet-layout KV cache), SwiGLU MLP, embeddings — the port
of ``repro/models/layers.py``.

Each layer is an ``nn.Module`` holding its weights (``Attention``, ``MLP``,
``Embedding``) plus a module-level function under the reference's name
(``attention``, ``decode_attention_blocks``, ``decode_cross_attention``,
``mlp``, ``embed``, ``unembed``), so each has a counterpart to find, and a
``spec_*`` function with the reference's logical partition specs of its
weights (``spec_norm``, ``spec_attention``, ``spec_mlp``,
``spec_embedding``; ``repro_torch.distributed.sharding``).
Weights used in matrix products are kept in ``dtype``: the configuration's
compute dtype by default (serving: cast once at load time), or its
``param_dtype`` (training: float32 master weights).  Every use casts the
weight to the compute dtype, as the reference's ``.astype(cd)`` does — for
weights already in it the cast is the identity.  Norm scales stay float32.

Prefill attention (causal self-attention, the encoder's bidirectional
attention and cross-attention to a context) is the reference's flash-style
chunked attention in plain PyTorch (f32 online softmax, no (S, S) tensor);
decode self-attention appends the new token's K/V to the block cache in
place and runs the hand-written ``decode_attention`` kernel (its plain
version on the CPU); decode cross-attention reads the context's dense K/V
in plain PyTorch, as the reference does in jnp.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.cfa.api import resolve_device
from repro_torch.distributed.sharding import P
from repro_torch.kernels.block_attention import append_token, decode_attention

from .config import ArchConfig

__all__ = [
    "rms_norm", "spec_norm", "apply_rope", "silu",
    "Attention", "spec_attention", "attention", "decode_attention_blocks",
    "decode_cross_attention",
    "MLP", "spec_mlp", "mlp",
    "Embedding", "spec_embedding", "embed", "unembed",
    "KVCache",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def torch_dtype(name: "str | torch.dtype") -> torch.dtype:
    """A configuration's dtype name as a torch dtype."""
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

def spec_norm() -> dict:
    return {"scale": P(None)}


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    half = d // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freqs = torch.exp(-math.log(theta) * ar / half)
    ang = positions.to(device=x.device, dtype=torch.float32)[..., None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference evaluates it, ``x * (1 / (1 +
    exp(-x)))`` one operation at a time in ``x``'s dtype: in bfloat16 each
    step rounds, as each jnp operation's result does.  ``F.silu`` rounds once
    and differs from it in about a third of bfloat16 outputs by one unit,
    enough to flip a near-tied MoE routing decision downstream."""
    return x * (1 / (1 + torch.exp(-x)))


def _normal(shape, scale: float, dtype: torch.dtype, generator, device) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in float32, then cast (the reference's
    ``_normal`` followed by its per-call compute-dtype cast)."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return (scale * x).to(dtype)


def _param(t: torch.Tensor) -> nn.Parameter:
    """A parameter, frozen until a training model asks for its gradient
    (``LM(..., dtype=)``)."""
    return nn.Parameter(t, requires_grad=False)


def _cd(cfg: ArchConfig) -> torch.dtype:
    """The configuration's compute dtype."""
    return torch_dtype(cfg.compute_dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """Facet(block)-layout KV cache: (B, nb, Hkv_stored, block, Dh)."""

    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def zeros(cfg: ArchConfig, batch: int, seq: int, dtype=torch.bfloat16,
              device="cuda") -> "KVCache":
        """Zeros on ``device``: the CUDA device unless the caller asks for
        the CPU (a missing card raises)."""
        device = resolve_device(device)
        bs = cfg.kv_block
        nb = -(-seq // bs)
        shape = (batch, nb, cfg.stored_kv_heads, bs, cfg.head_dim)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))


class Attention(nn.Module):
    """GQA self-attention weights: wq (d, Hq, Dh), wk/wv (d, Hkv, Dh),
    wo (Hq, Dh, d) in ``dtype`` (default: the compute dtype); q/k norm
    scales (Dh,) in float32 when the configuration has ``qk_norm``."""

    def __init__(self, cfg: ArchConfig, *, device="cuda", generator=None, dtype=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        d, hq, hkv, dh = cfg.d_model, cfg.padded_q_heads, cfg.stored_kv_heads, cfg.head_dim
        cd = dtype or _cd(cfg)
        shapes = {"wq": (d, hq, dh), "wk": (d, hkv, dh), "wv": (d, hkv, dh), "wo": (hq, dh, d)}
        for name, shape in shapes.items():
            setattr(self, name, _param(torch.zeros(shape, dtype=cd, device=device)))
        if cfg.qk_norm:
            self.q_norm = _param(torch.ones(dh, device=device))
            self.k_norm = _param(torch.ones(dh, device=device))
        if generator is not None:
            self._init(generator)

    @torch.no_grad()
    def _init(self, g: torch.Generator) -> None:
        cfg = self.cfg
        d, hq, dh = cfg.d_model, cfg.padded_q_heads, cfg.head_dim
        dev, cd = self.wq.device, self.wq.dtype
        scale = d ** -0.5
        wq = _normal((d, hq, dh), scale, torch.float32, g, dev)
        # kv weights are drawn per *real* kv head, then replicated, so the
        # stored-kv expansion is function-preserving GQA
        rep = cfg.stored_kv_heads // cfg.n_kv_heads
        wk = _normal((d, cfg.n_kv_heads, dh), scale, torch.float32, g, dev)
        wv = _normal((d, cfg.n_kv_heads, dh), scale, torch.float32, g, dev)
        wo = _normal((hq, dh, d), (hq * dh) ** -0.5, torch.float32, g, dev)
        # padded query heads get zero weights: they contribute nothing, exactly
        real = (torch.arange(hq, device=dev) < cfg.n_heads).float()
        self.wq.copy_((wq * real[None, :, None]).to(cd))
        self.wk.copy_(wk.repeat_interleave(rep, dim=1).to(cd))
        self.wv.copy_(wv.repeat_interleave(rep, dim=1).to(cd))
        self.wo.copy_((wo * real[:, None, None]).to(cd))


def spec_attention(cfg: ArchConfig) -> dict:
    """The reference's logical specs: wq/wk/wv column-parallel over 'model'
    (the head dim), wo row-parallel; the other weight dim FSDP over 'data'."""
    s = {
        "wq": P("data", "model", None),
        "wk": P("data", "model", None),
        "wv": P("data", "model", None),
        "wo": P("model", None, "data"),
    }
    if cfg.qk_norm:
        s["q_norm"] = spec_norm()
        s["k_norm"] = spec_norm()
    return s


def _project_qkv(m: Attention, x, kv_x, q_positions, kv_positions):
    """Q from ``x`` and K/V from ``kv_x``; RoPE on Q (K) at ``q_positions``
    (``kv_positions``), none where they are None."""
    cfg = m.cfg
    cd = _cd(cfg)
    xc, kc = x.to(cd), kv_x.to(cd)
    q = torch.einsum("bsd,dhk->bshk", xc, m.wq.to(cd))
    k = torch.einsum("bsd,dhk->bshk", kc, m.wk.to(cd))
    v = torch.einsum("bsd,dhk->bshk", kc, m.wv.to(cd))
    if cfg.qk_norm:
        q = rms_norm(q, m.q_norm)
        k = rms_norm(k, m.k_norm)
    if q_positions is not None:
        q = apply_rope(q, q_positions, cfg.rope_theta)
    if kv_positions is not None:
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def _chunked_attention(q, k, v, *, causal: bool, chunk: int):
    """Flash-style attention in plain PyTorch: a loop over query chunks, an
    inner loop over key chunks with an f32 online softmax (the reference's
    two nested scans), masked causally when ``causal``.  No (S, S) tensor is
    materialised."""
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    cq, ck = min(chunk, Sq), min(chunk, Sk)
    nq, nk = -(-Sq // cq), -(-Sk // ck)
    qpad, kpad = nq * cq - Sq, nk * ck - Sk
    dev = q.device
    qf = F.pad(q, (0, 0, 0, 0, 0, qpad)).float()
    kf = F.pad(k, (0, 0, 0, 0, 0, kpad)).float()
    vf = F.pad(v, (0, 0, 0, 0, 0, kpad)).float()
    scale = Dh ** -0.5
    kv_heads = k.shape[2]
    g = H // kv_heads

    qf = qf.reshape(B, nq, cq, kv_heads, g, Dh).permute(1, 0, 3, 4, 2, 5)
    kf = kf.reshape(B, nk, ck, kv_heads, Dh).permute(1, 0, 3, 2, 4)
    vf = vf.reshape(B, nk, ck, kv_heads, Dh).permute(1, 0, 3, 2, 4)

    q_pos = torch.arange(nq * cq, device=dev).reshape(nq, cq)
    k_pos = torch.arange(nk * ck, device=dev).reshape(nk, ck)
    k_valid = k_pos < Sk

    outs = []
    for i in range(nq):
        qc, qp = qf[i], q_pos[i]  # (B, kvh, g, cq, Dh), (cq,)
        m = torch.full((B, kv_heads, g, cq), float("-inf"), device=dev)
        l = torch.zeros((B, kv_heads, g, cq), device=dev)
        acc = torch.zeros((B, kv_heads, g, cq, Dh), device=dev)
        for j in range(nk):
            kc, vc, kp, kval = kf[j], vf[j], k_pos[j], k_valid[j]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc) * scale
            mask = kval[None, None, None, None, :]
            if causal:
                mask = mask & (qp[None, None, None, :, None] >= kp[None, None, None, None, :])
            s = torch.where(mask, s, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            pexp = torch.exp(s - m_safe[..., None])
            pexp = torch.where(mask, pexp, 0.0)
            l = l * alpha + pexp.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", pexp, vc)
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    # (nq, B, kvh, g, cq, Dh) -> (B, Sq, H, Dh)
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, nq * cq, H, Dh)
    return out[:, :Sq].to(q.dtype)


def attention(
    m: Attention,
    x: torch.Tensor,  # (B, S, d)
    *,
    positions: torch.Tensor | None = None,  # (S,) or (B, S)
    kv_x: torch.Tensor | None = None,  # cross-attention source (B, S_src, d)
    causal: bool = True,
    rope: bool = True,
    chunk: int = 512,
    cache: KVCache | None = None,  # if given, filled with the block-layout K/V
) -> tuple[torch.Tensor, KVCache | None]:
    """Self- or cross-attention over a full sequence (train forward /
    prefill).  Causal self-attention with RoPE by default; cross-attention
    takes K/V from ``kv_x`` (``causal=False, rope=False`` in the VLM and
    decoder layers; with RoPE only the queries rotate); the encoder runs
    ``causal=False, rope=True``.

    With ``cache``, the sequence's K/V are written into its blocks in place
    (positions past the sequence become zeros) and the cache is returned."""
    B, S, _ = x.shape
    src = x if kv_x is None else kv_x
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    qpos = positions if rope else None
    kpos = positions if rope and kv_x is None else None
    q, k, v = _project_qkv(m, x, src, qpos, kpos)
    out = _chunked_attention(q, k, v, causal=causal, chunk=chunk)
    if cache is not None:
        nb, bs = cache.k.shape[1], cache.k.shape[3]
        if S > nb * bs:
            raise ValueError(f"{S} tokens do not fit the cache's {nb * bs} slots")

        def to_blocks(t):
            t = F.pad(t, (0, 0, 0, 0, 0, nb * bs - S))
            return t.reshape(B, nb, bs, t.shape[2], t.shape[3]).permute(0, 1, 3, 2, 4)

        cache.k.copy_(to_blocks(k))
        cache.v.copy_(to_blocks(v))
    cd = _cd(m.cfg)
    y = torch.einsum("bshk,hkd->bsd", out.to(cd), m.wo.to(cd))
    return y, cache


def decode_attention_blocks(
    m: Attention,
    x: torch.Tensor,  # (B, 1, d)
    cache: KVCache,
    position,  # int or 0-d tensor, or (B,) per-lane positions
) -> tuple[torch.Tensor, KVCache]:
    """One decode step over the facet(block)-layout cache.

    The new token's K/V are appended with a single in-block store per head
    (in place); attention over the valid prefix ``pos + 1`` runs the
    ``decode_attention`` kernel.  ``position`` may be per lane (continuous
    batching): each sequence writes and masks at its own offset."""
    B = x.shape[0]
    cfg = m.cfg
    pos = torch.as_tensor(position, device=x.device).long()
    qpos = pos[:, None] if pos.dim() == 1 else pos[None, None]
    q, k, v = _project_qkv(m, x, x, qpos, qpos)
    append_token(cache.k, cache.v, k[:, 0], v[:, 0], pos)
    lengths = (pos + 1).expand(B)
    out = decode_attention(q[:, 0].contiguous(), cache.k, cache.v, lengths)  # (B, Hq, Dh)
    out = out.reshape(B, 1, cfg.padded_q_heads, cfg.head_dim)
    cd = _cd(cfg)
    y = torch.einsum("bshk,hkd->bsd", out.to(cd), m.wo.to(cd))
    return y, cache


def decode_cross_attention(
    m: Attention,
    x: torch.Tensor,  # (B, 1, d)
    k: torch.Tensor,  # (B, S_src, Hkv, Dh) the source's K, computed at prefill
    v: torch.Tensor,
) -> torch.Tensor:
    """One decode step of cross-attention over the whole source (no mask, no
    RoPE), in plain PyTorch with float32 scores as in the reference: the
    source's K/V are dense (B, S_src, Hkv, Dh), not in the block layout."""
    cfg = m.cfg
    B = x.shape[0]
    cd = _cd(cfg)
    q = torch.einsum("bsd,dhk->bshk", x.to(cd), m.wq.to(cd))
    if cfg.qk_norm:
        q = rms_norm(q, m.q_norm)
    hkv = k.shape[2]
    g = q.shape[2] // hkv
    qg = q.reshape(B, hkv, g, cfg.head_dim).float()
    s = torch.einsum("bhgk,bshk->bhgs", qg, k.float()) * (cfg.head_dim ** -0.5)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshk->bhgk", w, v.float()).reshape(B, 1, hkv * g, cfg.head_dim)
    return torch.einsum("bshk,hkd->bsd", out.to(cd), m.wo.to(cd))


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU weights w1/w3 (d, f) and w2 (f, d) in ``dtype`` (default: the
    compute dtype)."""

    def __init__(self, cfg: ArchConfig, d_ff: int | None = None, *, device="cuda",
                 generator=None, dtype=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        d, f = cfg.d_model, d_ff or cfg.d_ff
        cd = dtype or _cd(cfg)
        self.w1 = _param(torch.zeros((d, f), dtype=cd, device=device))
        self.w3 = _param(torch.zeros((d, f), dtype=cd, device=device))
        self.w2 = _param(torch.zeros((f, d), dtype=cd, device=device))
        if generator is not None:
            with torch.no_grad():
                dev = self.w1.device
                self.w1.copy_(_normal((d, f), d ** -0.5, cd, generator, dev))
                self.w3.copy_(_normal((d, f), d ** -0.5, cd, generator, dev))
                self.w2.copy_(_normal((f, d), f ** -0.5, cd, generator, dev))


def spec_mlp() -> dict:
    return {
        "w1": P("data", "model"),
        "w3": P("data", "model"),
        "w2": P("model", "data"),
    }


def mlp(m: MLP, x: torch.Tensor) -> torch.Tensor:
    cd = _cd(m.cfg)
    xc = x.to(cd)
    h = silu(xc @ m.w1.to(cd)) * (xc @ m.w3.to(cd))
    return h @ m.w2.to(cd)


# ---------------------------------------------------------------------------
# embedding / unembedding (padded vocab)
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    """Token table (padded_vocab, d) and output head (d, padded_vocab) in
    ``dtype`` (default: the compute dtype)."""

    def __init__(self, cfg: ArchConfig, *, device="cuda", generator=None, dtype=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        vp, d = cfg.padded_vocab, cfg.d_model
        cd = dtype or _cd(cfg)
        self.table = _param(torch.zeros((vp, d), dtype=cd, device=device))
        self.head = _param(torch.zeros((d, vp), dtype=cd, device=device))
        if generator is not None:
            with torch.no_grad():
                dev = self.table.device
                self.table.copy_(_normal((vp, d), 1.0, cd, generator, dev))
                self.head.copy_(_normal((d, vp), d ** -0.5, cd, generator, dev))


def spec_embedding() -> dict:
    # the table vocab-parallel only, as the reference (sharding d as well
    # made its gather degenerate to full-batch all-gathers)
    return {"table": P("model", None), "head": P(None, "model")}


def embed(m: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    table = m.table  # read once: a sharded model gathers it on each read
    return table.to(_cd(m.cfg))[tokens.to(table.device)]


def unembed(m: Embedding, x: torch.Tensor) -> torch.Tensor:
    cd = _cd(m.cfg)
    return x.to(cd) @ m.head.to(cd)  # (B, S, padded_vocab)
