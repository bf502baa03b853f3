"""Symmetric per-tensor int8 quantization (the ``halo_quantize`` hook) and
error-feedback gradient compression (``TrainHParams.compress_grads``).

The PyTorch counterpart of the reference's
``repro/distributed/compression.py``: ``quantize_int8``/``dequantize_int8``
and ``ef_init``/``ef_compress``, which quantize each gradient plus the
residual carried from the step before and carry the new residual
(Karimireddy et al., 2019).  Gradients and residuals are lists of tensors,
one per leaf.  Bit-exact against the reference in
float32 (and on inputs cast from float64, which it quantizes in float32):
the scale divides by a 0-d tensor on the input's device — CUDA PyTorch
turns division by a Python scalar into a multiply by its rounded
reciprocal — and ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch

__all__ = ["quantize_int8", "dequantize_int8", "ef_init", "ef_compress"]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: returns (q, scale), the
    scale a 0-d float32 tensor on ``x``'s device."""
    xf = x.to(torch.float32)
    scale = torch.clamp_min(xf.abs().max(), 1e-12) / xf.new_tensor(127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_init(params: list[torch.Tensor]) -> list[torch.Tensor]:
    """Zero residuals, float32, laid out as each leaf (DTensors too)."""
    return [torch.zeros_like(p, dtype=torch.float32) for p in params]


def ef_compress(grads: list[torch.Tensor], error_state: list[torch.Tensor]
                ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Quantize (grad + carried error); carry the new residual."""
    new_grads, new_err = [], []
    for g, e in zip(grads, error_state):
        target = g.to(torch.float32) + e
        deq = dequantize_int8(*quantize_int8(target))
        new_grads.append(deq.to(g.dtype))
        new_err.append(target - deq)
    return new_grads, new_err
