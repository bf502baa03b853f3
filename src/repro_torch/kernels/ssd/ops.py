"""Public ops for the SSD chunk scan (the port of ``repro/kernels/ssd/ops.py``)."""
from __future__ import annotations

import torch

from .ref import ssd_chunked_bwd_ref, ssd_chunked_ref, ssd_scan_ref
from .ssd import ssd_scan, ssd_scan_bwd

__all__ = ["ssd_scan", "ssd_scan_bwd", "ssd_scan_ref", "ssd_chunked_ref", "ssd_chunked_bwd_ref",
           "ssd_decode_step"]


def ssd_decode_step(
    state: torch.Tensor,  # (B, H, P, N)
    x_t: torch.Tensor,  # (B, H, P)
    loga_t: torch.Tensor,  # (B, H)
    B_t: torch.Tensor,  # (B, N)
    C_t: torch.Tensor,  # (B, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD update (decode): the state *is* the whole cache.

    One (H, P, N) read-modify-write per token — contiguous by construction,
    the degenerate (chunk = 1) case of the facet scheme.  Returns y_t in
    ``x_t.dtype`` and the new float32 state.
    """
    a_t = torch.exp(loga_t.float())[:, :, None, None]
    S = a_t * state.float() + x_t.float()[..., None] * B_t.float()[:, None, None, :]
    y_t = torch.einsum("bhpn,bn->bhp", S, C_t.float())
    return y_t.to(x_t.dtype), S
