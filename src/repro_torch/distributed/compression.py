"""Symmetric per-tensor int8 quantization (the ``halo_quantize`` hook).

The PyTorch counterpart of ``quantize_int8``/``dequantize_int8`` of the
reference's ``repro/distributed/compression.py``; its error-feedback
helpers belong to the training slice.  Bit-exact against the reference in
float32 (and on inputs cast from float64, which it quantizes in float32):
the scale divides by a 0-d tensor on the input's device — CUDA PyTorch
turns division by a Python scalar into a multiply by its rounded
reciprocal — and ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch

__all__ = ["quantize_int8", "dequantize_int8"]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: returns (q, scale), the
    scale a 0-d float32 tensor on ``x``'s device."""
    xf = x.to(torch.float32)
    scale = torch.clamp_min(xf.abs().max(), 1e-12) / xf.new_tensor(127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
