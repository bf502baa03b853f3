"""Plain PyTorch version of the facet-layout decode attention (the port of
``repro/kernels/block_attention/ref.py``).

The reference computes standard GQA decode attention over a *canonical*
``(B, S, Hkv, D)`` cache; the kernel computes the same function over the CFA
block layout ``(B, nb, Hkv, bs, D)``.  ``blockify``/``deblockify`` are the
layout converters (the sequence axis is tiled, the block index is the
single-assignment outer dimension, and each ``(bs, D)`` extent is one
contiguous burst).  On the CPU the ``decode_attention`` wrapper runs
``decode_attention_ref`` over ``deblockify`` of its blocks.
"""
from __future__ import annotations

import torch

__all__ = ["decode_attention_ref", "blockify", "deblockify"]


def blockify(cache: torch.Tensor, block_size: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, nb, Hkv, bs, D), contiguous; S must divide by
    block_size."""
    B, S, H, D = cache.shape
    if S % block_size:
        raise ValueError(f"S={S} must divide by block_size={block_size}")
    nb = S // block_size
    return cache.reshape(B, nb, block_size, H, D).permute(0, 1, 3, 2, 4).contiguous()


def deblockify(blocks: torch.Tensor) -> torch.Tensor:
    """(B, nb, Hkv, bs, D) -> (B, S, Hkv, D)."""
    B, nb, H, bs, D = blocks.shape
    return blocks.permute(0, 1, 3, 2, 4).reshape(B, nb * bs, H, D)


def decode_attention_ref(
    q: torch.Tensor,  # (B, Hq, D)
    k_cache: torch.Tensor,  # (B, S, Hkv, D) canonical layout
    v_cache: torch.Tensor,  # (B, S, Hkv, D)
    lengths: torch.Tensor,  # (B,) int — valid prefix length per sequence
) -> torch.Tensor:  # (B, Hq, D)
    B, S, Hkv, D = k_cache.shape
    Hq = q.shape[1]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    k = k_cache.float()
    v = v_cache.float()
    scale = torch.sqrt(torch.tensor(float(D), dtype=torch.float32, device=q.device))
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k) / scale
    lengths = torch.as_tensor(lengths, device=q.device)
    mask = torch.arange(S, device=q.device)[None, :] < lengths[:, None]  # (B, S)
    scores = torch.where(mask[:, None, None, :], scores, float("-inf"))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p, v)
    return out.reshape(B, Hq, D).to(q.dtype)
