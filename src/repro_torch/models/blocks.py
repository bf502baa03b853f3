"""Layer blocks: one pre-norm residual position of the reference's period
(the port of ``repro/models/blocks.py``).

Layer kinds:

* ``attn``  — causal self-attention (+ FFN),
* ``mamba`` — SSD mixer (+ FFN; none in a pure-SSM LM),
* ``cross`` — cross-attention to a static context (VLM image layers), its
  output scaled by ``tanh(gate)`` (a float32 scalar that starts at 0),
* ``dec``   — self-attention + cross-attention (encoder-decoder decoder
  layers).

FFN kinds: ``mlp`` (SwiGLU), ``moe`` (top-k experts), ``none``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.cfa.api import resolve_device
from repro_torch.distributed.sharding import P

from .config import ArchConfig
from .layers import (
    MLP,
    Attention,
    KVCache,
    _param,
    attention,
    decode_attention_blocks,
    decode_cross_attention,
    mlp,
    rms_norm,
    spec_attention,
    spec_mlp,
    spec_norm,
    torch_dtype,
)
from .mamba2 import Mamba2, MambaCache, mamba_decode, mamba_prefill, mamba_train, spec_mamba
from .moe import MoE, moe, spec_moe

__all__ = ["Block", "ffn_kind", "init_position", "spec_position", "cache_position",
           "apply_position"]

_KINDS = ("attn", "mamba", "cross", "dec")


def ffn_kind(cfg: ArchConfig, pos: int) -> str:
    if pos in cfg.moe_positions:
        return "moe"
    if cfg.period[pos] == "mamba" and cfg.family == "ssm":
        return "none"
    return "mlp"


class Block(nn.Module):
    """One period position: ``norm1`` + mixer (``cross``: + ``gate``;
    ``dec``: + ``norm_x`` and the ``cross`` attention), then ``norm2`` + FFN
    unless the FFN kind is ``none``."""

    def __init__(self, kind: str, fk: str, cfg: ArchConfig, *, device="cuda", generator=None,
                 dtype=None):
        super().__init__()
        device = resolve_device(device)
        if kind not in _KINDS:
            raise ValueError(kind)
        self.kind, self.fk, self.cfg = kind, fk, cfg
        kw = dict(device=device, generator=generator, dtype=dtype)
        self.norm1 = _param(torch.ones(cfg.d_model, device=device))
        mixer = Mamba2 if kind == "mamba" else Attention
        self.mixer = mixer(cfg, **kw)
        if kind == "cross":
            self.gate = _param(torch.zeros((), device=device))
        if kind == "dec":
            self.norm_x = _param(torch.ones(cfg.d_model, device=device))
            self.cross = Attention(cfg, **kw)
        if fk != "none":
            self.norm2 = _param(torch.ones(cfg.d_model, device=device))
            ffn = MoE if fk == "moe" else MLP
            self.ffn = ffn(cfg, **kw)


def init_position(kind: str, fk: str, cfg: ArchConfig, *, generator=None,
                  device="cuda", dtype=None) -> Block:
    """One layer (the reference's ``init_position``): weights drawn from
    ``generator``, or zeros to be loaded when it is None; matrices in
    ``dtype`` (default: the compute dtype); on ``device``, the CUDA device
    unless the caller asks for the CPU (a missing card raises)."""
    return Block(kind, fk, cfg, device=device, generator=generator, dtype=dtype)


def spec_position(kind: str, fk: str, cfg: ArchConfig) -> dict:
    """The reference's logical specs of one layer's weights, keyed as its
    pytree (a norm is ``{"scale": ...}``)."""
    s: dict = {"norm1": spec_norm()}
    if kind == "mamba":
        s["mixer"] = spec_mamba(cfg)
    else:
        s["mixer"] = spec_attention(cfg)
    if kind == "cross":
        s["gate"] = P()
    if kind == "dec":
        s["norm_x"] = spec_norm()
        s["cross"] = spec_attention(cfg)
    if fk != "none":
        s["norm2"] = spec_norm()
        s["ffn"] = spec_moe() if fk == "moe" else spec_mlp()
    return s


def cache_position(kind: str, cfg: ArchConfig, batch: int, seq: int,
                   dtype=torch.bfloat16, device="cuda", *, src_len: int = 0) -> dict:
    """Zero-initialised decode cache slot for one layer, on the CUDA device
    unless the caller asks for the CPU: ``kv`` (self-attention), ``ssm``
    (Mamba) and, for ``cross``/``dec``, the context's K/V ``cross_k`` /
    ``cross_v`` (B, src_len, stored_kv_heads, Dh)."""
    if kind not in _KINDS:
        raise ValueError(kind)
    slot: dict = {}
    if kind in ("attn", "dec"):
        slot["kv"] = KVCache.zeros(cfg, batch, seq, dtype, device)
    if kind == "mamba":
        slot["ssm"] = MambaCache.zeros(cfg, batch, dtype, device)
    if kind in ("cross", "dec"):
        shape = (batch, src_len, cfg.stored_kv_heads, cfg.head_dim)
        device = resolve_device(device)
        slot["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
        slot["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return slot


def _cross_kv(m: Attention, src: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The context's K/V for decode cross-attention (no RoPE)."""
    cd = torch_dtype(m.cfg.compute_dtype)
    sc = src.to(cd)
    k = torch.einsum("bsd,dhk->bshk", sc, m.wk.to(cd))
    v = torch.einsum("bsd,dhk->bshk", sc, m.wv.to(cd))
    if m.cfg.qk_norm:
        k = rms_norm(k, m.k_norm)
    return k, v


def _cross(m: Attention, h, mode: str, cache: dict | None, ctx: dict) -> torch.Tensor:
    """Cross-attention of ``h`` to the context: over the K/V stored in the
    cache slot when decoding, else over ``ctx["cross_src"]`` (whose K/V a
    prefill stores in the slot, in place)."""
    if mode == "decode":
        return decode_cross_attention(m, h, cache["cross_k"], cache["cross_v"])
    src = ctx["cross_src"]
    y, _ = attention(m, h, kv_x=src, causal=False, rope=False)
    if mode == "prefill":
        k, v = _cross_kv(m, src)
        cache["cross_k"].copy_(k)
        cache["cross_v"].copy_(v)
    return y


def _self(m: Attention, h, mode: str, cache: dict | None, ctx: dict) -> torch.Tensor:
    if mode == "decode":
        y, _ = decode_attention_blocks(m, h, cache["kv"], ctx["decode_pos"])
    else:
        y, _ = attention(m, h, positions=ctx.get("positions"),
                         cache=cache["kv"] if mode == "prefill" else None)
    return y


def apply_position(
    block: Block,
    x: torch.Tensor,
    mode: str,  # train | prefill | decode
    cache: dict | None,
    ctx: dict,
) -> tuple[torch.Tensor, dict | None, "torch.Tensor | float"]:
    """Apply one layer.  Returns (x, cache slot, aux loss): in prefill and
    decode the slot is ``cache``, updated in place; in train it is None.
    The aux loss is the MoE's load-balance loss (a float32 0-d tensor), else
    0.0 (no launch on the card for layers without experts)."""
    aux = 0.0
    h = rms_norm(x, block.norm1)
    if block.kind == "attn":
        x = x + _self(block.mixer, h, mode, cache, ctx)
    elif block.kind == "mamba":
        if mode == "decode":
            y, _ = mamba_decode(block.mixer, h, cache["ssm"])
        elif mode == "prefill":
            y, _ = mamba_prefill(block.mixer, h, cache["ssm"])
        else:
            y = mamba_train(block.mixer, h)
        x = x + y
    elif block.kind == "cross":
        y = _cross(block.mixer, h, mode, cache, ctx)
        x = x + torch.tanh(block.gate).to(y.dtype) * y
    else:  # dec
        y = _self(block.mixer, h, mode, cache, ctx)
        hx = rms_norm(x + y, block.norm_x)
        x = x + y + _cross(block.cross, hx, mode, cache, ctx)
    if block.fk != "none":
        h2 = rms_norm(x, block.norm2)
        if block.fk == "moe":
            y2, aux = moe(block.ffn, h2, ctx.get("dp_groups", ()))
        else:
            y2 = mlp(block.ffn, h2)
        x = x + y2
    return x, (cache if mode != "train" else None), aux
