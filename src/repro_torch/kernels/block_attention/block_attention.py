"""CUDA kernel: decode attention over the facet(block)-layout KV cache (the
wrapper around ``csrc/block_attention.cu``).

Replaces the reference package's Pallas kernel
``repro/kernels/block_attention/block_attention.py::decode_attention`` (body
``_kernel``): one GQA decode step, ``q (B, Hq, D)`` against a block-layout
cache ``(B, nb, Hkv, bs, D)`` whose ``(bs, D)`` extents are the contiguous
bursts of the CFA layout, masked at ``pos >= lengths[b]``.

The kernel is bounded by memory (the valid K/V prefix is read once for all
``Hq/Hkv`` query heads of a kv head); its design (one CTA per (kv head,
batch row), key tiles over the valid prefix only, staged in shared memory,
f32 online softmax) is in the source's header note.  It matches the plain version
(:func:`~repro_torch.kernels.block_attention.ref.decode_attention_ref` over
:func:`deblockify`) to float rounding: the sums run in another order.

For tensors on the CPU the wrapper runs the plain version; for CUDA tensors
it launches the kernel or raises — it never falls back.
``decode_attention.launches`` counts kernel launches (the plain path does
not count).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .ref import decode_attention_ref, deblockify

__all__ = ["decode_attention"]

_SOURCE = "block_attention"
_VOID = ctypes.c_void_p
_INT = ctypes.c_int
#: dtype codes of the C interface
_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: (q dtype, K/V dtype) pairs the kernel is built for
_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16)}
MAX_HEAD_DIM = 256
#: dynamic shared memory a block can use on sm_90
MAX_SMEM = 232448
#: key positions per tile (``kTile`` in the source)
TILE = 64


@functools.lru_cache(maxsize=None)
def _kernel():
    from repro_torch.kernels import _build

    fn = _build.library(_SOURCE).decode_attention
    fn.argtypes = [_INT, _INT, _VOID, _VOID, _VOID, _VOID, _VOID,
                   _INT, _INT, _INT, _INT, _INT, _INT, _VOID]
    fn.restype = _INT
    return fn


def decode_attention(
    q: torch.Tensor,  # (B, Hq, D)
    k_blocks: torch.Tensor,  # (B, nb, Hkv, bs, D) facet layout
    v_blocks: torch.Tensor,  # (B, nb, Hkv, bs, D)
    lengths: torch.Tensor,  # (B,) int — valid prefix length per row
) -> torch.Tensor:  # (B, Hq, D) in q.dtype
    if q.dim() != 3 or k_blocks.dim() != 5 or k_blocks.shape != v_blocks.shape:
        raise ValueError(f"want q (B,Hq,D) and K/V (B,nb,Hkv,bs,D), got "
                         f"{tuple(q.shape)}, {tuple(k_blocks.shape)}, {tuple(v_blocks.shape)}")
    B, nb, Hkv, bs, D = k_blocks.shape
    Hq = q.shape[1]
    if q.shape[0] != B or q.shape[2] != D:
        raise ValueError(f"q {tuple(q.shape)} does not match the cache {tuple(k_blocks.shape)}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    lengths = torch.as_tensor(lengths)
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be ({B},), got {tuple(lengths.shape)}")
    devices = {t.device for t in (q, k_blocks, v_blocks)}
    if len(devices) != 1:
        raise ValueError(f"q, K and V must share one device, got {sorted(map(str, devices))}")
    device = q.device
    if device.type == "cpu":
        return decode_attention_ref(q, deblockify(k_blocks), deblockify(v_blocks), lengths)
    if device.type != "cuda":
        raise ValueError(f"tensors must be on a CUDA device or the CPU, got {device}")
    if k_blocks.dtype != v_blocks.dtype or (q.dtype, k_blocks.dtype) not in _PAIRS:
        raise TypeError(f"the kernel takes (q, K/V) dtypes {sorted(map(str, _PAIRS))}, got "
                        f"{q.dtype}, {k_blocks.dtype}/{v_blocks.dtype}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {MAX_HEAD_DIM}")
    G = Hq // Hkv
    smem = 4 * (2 * G * D + G * TILE + 3 * G + 2 * TILE * D)
    if smem > MAX_SMEM:
        raise ValueError(f"{G} query heads per kv head at D={D} need {smem} B of shared "
                         f"memory > {MAX_SMEM}")
    if not all(t.is_contiguous() for t in (q, k_blocks, v_blocks)):
        raise ValueError("q, K and V must be contiguous")
    lengths = lengths.to(device=device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    fn = _kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_CODES[q.dtype], _CODES[k_blocks.dtype], q.data_ptr(), k_blocks.data_ptr(),
                v_blocks.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                B, Hq, Hkv, nb, bs, D, stream)
    if rc != 0:
        raise RuntimeError(
            f"decode_attention kernel launch failed for q {tuple(q.shape)} {q.dtype}, "
            f"K/V {tuple(k_blocks.shape)} {k_blocks.dtype}: cudaError_t {rc}")
    decode_attention.launches += 1
    return out


#: kernel launches since the last reset (set to 0 to reset)
decode_attention.launches = 0
