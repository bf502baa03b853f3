"""Plain PyTorch version of the Mamba2 block's epilogue: the D skip, the SiLU
gate and the RMSNorm between the SSD scan and the output projection, as the
full-sequence block has always computed them (``models/mamba2.py``).  The
``gated_rms_norm`` wrapper runs it for tensors on the CPU (and for ``meta``
tensors, shapes only); the CUDA kernel is held against it on the card.

``gated_rms_norm_bwd_ref`` is the gradient the backward kernel is held to:
the exact derivative, in float64, at the point the plain version's forward
reaches."""
from __future__ import annotations

import torch

from repro_torch.kernels.elementwise import rms_norm, silu

__all__ = ["gated_rms_norm_ref", "gated_rms_norm_bwd_ref"]


def gated_rms_norm_ref(
    y: torch.Tensor,  # (B, S, H, P): the scan's output
    xh: torch.Tensor,  # (B, S, H, P): the scan's input
    z: torch.Tensor,  # (B, S, H*P): the gate's projection
    D: torch.Tensor,  # (H,) float32
    norm: torch.Tensor,  # (H*P,) float32: the norm's scale
) -> torch.Tensor:
    """``rms_norm((y + D xh) * silu(z), norm)`` in ``y``'s dtype (D cast to
    it first), (B, S, H*P)."""
    B, S, h, pd = y.shape
    y = y + D[None, None, :, None].to(y.dtype) * xh
    y = y.reshape(B, S, h * pd)
    return rms_norm(y * silu(z), norm)


def gated_rms_norm_bwd_ref(
    y: torch.Tensor,
    xh: torch.Tensor,
    z: torch.Tensor,
    D: torch.Tensor,
    norm: torch.Tensor,
    dout: torch.Tensor,  # (B, S, H*P): the output's gradient
) -> tuple[torch.Tensor, ...]:
    """(dy, dxh, dz, dD, dnorm) in float64, dxh the D term alone: autograd in
    float64 through the epilogue, where D in ``y``'s dtype, u = y + D xh,
    s = silu(z) and g = u s each take the value the plain version computes
    (its roundings in ``y``'s dtype) while their derivatives stay exact.  A
    backward that recomputes the forward's rounded values and works in
    float32 differs from it by its own arithmetic and one rounding of each
    gradient; one that rounds every step, as autograd through the plain
    version in bfloat16 does, differs by more."""
    B, S, h, pd = y.shape
    d_r = D.to(y.dtype)
    u_r = (y + d_r[None, None, :, None] * xh).reshape(B, S, h * pd)
    s_r = silu(z)
    g_r = u_r * s_r

    def held(exact: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        """``value`` forward, ``exact``'s derivative backward."""
        return exact + (value.double() - exact).detach()

    with torch.enable_grad():
        leaves = [t.detach().double().requires_grad_() for t in (y, xh, z, D, norm)]
        y64, xh64, z64, d64, norm64 = leaves
        d = held(d64, d_r)[None, None, :, None]
        u = held((y64 + d * xh64).reshape(B, S, h * pd), u_r)
        s = held(z64 * torch.sigmoid(z64), s_r)
        g = held(u * s, g_r)
        # rms_norm's epsilon (kernels.elementwise.rms_norm)
        out = g * torch.rsqrt(torch.mean(g * g, dim=-1, keepdim=True) + 1e-6) * norm64
        return torch.autograd.grad(out, leaves, dout.double())
