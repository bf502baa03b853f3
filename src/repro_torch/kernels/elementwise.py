"""``rms_norm`` and ``silu``, whose rounding the models
(``repro_torch.models.layers``) and the kernels' plain versions share: here,
so that no kernel imports a model."""
from __future__ import annotations

import torch

__all__ = ["rms_norm", "silu"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference evaluates it, ``x * (1 / (1 +
    exp(-x)))`` one operation at a time in ``x``'s dtype: in bfloat16 each
    step rounds, as each jnp operation's result does.  ``F.silu`` rounds once
    and differs from it in about a third of bfloat16 outputs by one unit,
    enough to flip a near-tied MoE routing decision downstream."""
    return x * (1 / (1 + torch.exp(-x)))
