"""Layer blocks: one pre-norm residual position of the reference's period
(the port of ``repro/models/blocks.py``).

Layer kinds ported: ``attn`` (causal self-attention + FFN) and ``mamba``
(SSD mixer, with no FFN in a pure-SSM LM).  FFN kinds ported: ``mlp``
(SwiGLU) and ``none``.  ``moe``, ``cross`` and ``dec`` raise
``NotImplementedError``: they wait for the MoE and cross/dec + encoder
slices of the port.
"""
from __future__ import annotations

import torch
from torch import nn

from .config import ArchConfig
from .layers import (
    MLP,
    Attention,
    KVCache,
    _param,
    attention,
    decode_attention_blocks,
    mlp,
    rms_norm,
)
from .mamba2 import Mamba2, MambaCache, mamba_decode, mamba_prefill, mamba_train

__all__ = ["Block", "ffn_kind", "init_position", "cache_position", "apply_position",
           "check_supported"]

_LATER = {
    "moe": "the MoE slice",
    "cross": "the cross-attention (VLM) slice",
    "dec": "the encoder-decoder slice",
}


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet; it waits for {_LATER[what]}")


def ffn_kind(cfg: ArchConfig, pos: int) -> str:
    if pos in cfg.moe_positions:
        return "moe"
    if cfg.period[pos] == "mamba" and cfg.family == "ssm":
        return "none"
    return "mlp"


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration this port cannot
    run yet (experts, cross-attention, encoder-decoder)."""
    for i, kind in enumerate(cfg.period):
        if kind not in ("attn", "mamba"):
            raise _unsupported(kind)
        if ffn_kind(cfg, i) == "moe":
            raise _unsupported("moe")
    if cfg.is_encdec:
        raise _unsupported("dec")


class Block(nn.Module):
    """One period position: ``norm1`` + mixer, then ``norm2`` + FFN unless
    the FFN kind is ``none``."""

    def __init__(self, kind: str, fk: str, cfg: ArchConfig, *, device=None, generator=None):
        super().__init__()
        if kind not in ("attn", "mamba"):
            raise _unsupported(kind)
        if fk == "moe":
            raise _unsupported("moe")
        self.kind, self.fk, self.cfg = kind, fk, cfg
        self.norm1 = _param(torch.ones(cfg.d_model, device=device))
        mixer = Attention if kind == "attn" else Mamba2
        self.mixer = mixer(cfg, device=device, generator=generator)
        if fk != "none":
            self.norm2 = _param(torch.ones(cfg.d_model, device=device))
            self.ffn = MLP(cfg, device=device, generator=generator)


def init_position(kind: str, fk: str, cfg: ArchConfig, *, generator=None,
                  device=None) -> Block:
    """One layer (the reference's ``init_position``): weights drawn from
    ``generator``, or zeros to be loaded when it is None."""
    return Block(kind, fk, cfg, device=device, generator=generator)


def cache_position(kind: str, cfg: ArchConfig, batch: int, seq: int,
                   dtype=torch.bfloat16, device="cuda") -> dict:
    """Zero-initialised decode cache slot for one layer, on the CUDA device
    unless the caller asks for the CPU."""
    if kind == "attn":
        return {"kv": KVCache.zeros(cfg, batch, seq, dtype, device)}
    if kind == "mamba":
        return {"ssm": MambaCache.zeros(cfg, batch, dtype, device)}
    raise _unsupported(kind)


def apply_position(
    block: Block,
    x: torch.Tensor,
    mode: str,  # train | prefill | decode
    cache: dict | None,
    ctx: dict,
) -> tuple[torch.Tensor, dict | None]:
    """Apply one layer.  Returns (x, cache slot): in prefill and decode the
    slot is ``cache``, updated in place; in train it is None."""
    h = rms_norm(x, block.norm1)
    if block.kind == "attn":
        if mode == "decode":
            y, _ = decode_attention_blocks(block.mixer, h, cache["kv"], ctx["decode_pos"])
        else:
            y, _ = attention(block.mixer, h, positions=ctx.get("positions"),
                             cache=cache["kv"] if mode == "prefill" else None)
    else:
        if mode == "decode":
            y, _ = mamba_decode(block.mixer, h, cache["ssm"])
        elif mode == "prefill":
            y, _ = mamba_prefill(block.mixer, h, cache["ssm"])
        else:
            y = mamba_train(block.mixer, h)
    x = x + y
    if block.fk != "none":
        x = x + mlp(block.ffn, rms_norm(x, block.norm2))
    return x, (cache if mode != "train" else None)
