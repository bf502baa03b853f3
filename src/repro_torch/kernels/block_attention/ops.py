"""Public ops for the facet-layout KV cache (the port of
``repro/kernels/block_attention/ops.py``)."""
from __future__ import annotations

import torch

from .block_attention import decode_attention
from .ref import blockify, deblockify, decode_attention_ref

__all__ = [
    "decode_attention",
    "decode_attention_ref",
    "blockify",
    "deblockify",
    "append_token",
]


def append_token(
    k_blocks: torch.Tensor,  # (B, nb, Hkv, bs, D)
    v_blocks: torch.Tensor,
    k_new: torch.Tensor,  # (B, Hkv, D)
    v_new: torch.Tensor,
    position,  # int or 0-d tensor (the same for the batch), or (B,) per row
) -> tuple[torch.Tensor, torch.Tensor]:
    """Append one token's K/V at ``position``: a single in-block write per
    head (the CFA flow-out stance — all writes are block-local and
    contiguous).

    Unlike the reference (a functional update) this writes into ``k_blocks``
    and ``v_blocks`` in place and returns them; ``position`` may also be one
    per batch row.  A position past the cache's capacity raises (the
    reference's ``dynamic_update_slice`` would clamp it)."""
    B, nb, _, bs, _ = k_blocks.shape
    pos = torch.as_tensor(position).long()
    if pos.dim() == 0:
        pos = pos.expand(B)
    if pos.shape != (B,):
        raise ValueError(f"position must be a scalar or ({B},), got {tuple(pos.shape)}")
    if pos.device.type == "cpu" and bool((pos < 0).any() or (pos >= nb * bs).any()):
        raise IndexError(f"position {pos.tolist()} outside the cache's {nb * bs} slots")
    pos = pos.to(k_blocks.device)
    rows = torch.arange(B, device=k_blocks.device)
    blk, row = pos // bs, pos % bs
    k_blocks[rows, blk, :, row, :] = k_new.to(k_blocks.dtype)
    v_blocks[rows, blk, :, row, :] = v_new.to(v_blocks.dtype)
    return k_blocks, v_blocks
