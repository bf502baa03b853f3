"""CUDA kernel: the chunked Mamba2 SSD scan (the wrapper around
``csrc/ssd_scan.cu``).

Replaces the reference package's Pallas kernel
``repro/kernels/ssd/ssd.py::ssd_scan`` (body ``_kernel``): the SSD recurrence
in chunks of ``chunk`` steps, the inter-chunk state carried in float32 as
the chunk's CFA flow-out facet.  Returns ``y (B, T, H, P)`` in ``x.dtype``
and the final state ``(B, H, P, N)`` in float32; needs ``T % chunk == 0``,
as the reference does.

The kernel is bounded by arithmetic; its design (one CTA per (head, batch
row) walking the chunks, the state and the chunk in shared memory, only the
causal half of the decay matrix formed) is in the source's header note.  It
matches the plain version
(:func:`~repro_torch.kernels.ssd.ref.ssd_chunked_ref`) to float rounding.

For tensors on the CPU the wrapper runs the plain version; for CUDA tensors
it launches the kernel or raises — it never falls back.
``ssd_scan.launches`` counts kernel launches (the plain path does not count).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .ref import ssd_chunked_ref

__all__ = ["ssd_scan"]

_SOURCE = "ssd_scan"
_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 128
MAX_STATE = 256
#: dynamic shared memory a block can use on sm_90
MAX_SMEM = 232448


@functools.lru_cache(maxsize=None)
def _kernel():
    from repro_torch.kernels import _build

    fn = _build.library(_SOURCE).ssd_scan
    fn.argtypes = [_INT, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID,
                   _INT, _INT, _INT, _INT, _INT, _INT, _VOID]
    fn.restype = _INT
    return fn


def ssd_scan(
    x: torch.Tensor,  # (B, T, H, P)
    loga: torch.Tensor,  # (B, T, H) float32
    Bmat: torch.Tensor,  # (B, T, N)
    C: torch.Tensor,  # (B, T, N)
    *,
    chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan; returns (y (B,T,H,P), final state (B,H,P,N))."""
    if x.dim() != 4 or loga.dim() != 3 or Bmat.dim() != 3 or C.shape != Bmat.shape:
        raise ValueError(f"want x (B,T,H,P), loga (B,T,H), B/C (B,T,N), got "
                         f"{tuple(x.shape)}, {tuple(loga.shape)}, {tuple(Bmat.shape)}, "
                         f"{tuple(C.shape)}")
    Bb, T, H, P = x.shape
    N = Bmat.shape[-1]
    if loga.shape != (Bb, T, H) or Bmat.shape[:2] != (Bb, T):
        raise ValueError(f"loga {tuple(loga.shape)} / B {tuple(Bmat.shape)} do not match "
                         f"x {tuple(x.shape)}")
    if T % chunk:
        raise ValueError(f"T={T} must divide by chunk={chunk}")
    devices = {t.device for t in (x, loga, Bmat, C)}
    if len(devices) != 1:
        raise ValueError(f"x, loga, B and C must share one device, got "
                         f"{sorted(map(str, devices))}")
    device = x.device
    if device.type == "cpu":
        return ssd_chunked_ref(x, loga, Bmat, C, chunk)
    if device.type != "cuda":
        raise ValueError(f"tensors must be on a CUDA device or the CPU, got {device}")
    if x.dtype not in _CODES or Bmat.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"x, B and C must share a dtype of {sorted(map(str, _CODES))}, got "
                        f"{x.dtype}, {Bmat.dtype}, {C.dtype}")
    if loga.dtype != torch.float32:
        raise TypeError(f"loga must be float32, got {loga.dtype}")
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside (0, {MAX_CHUNK}]")
    if N > MAX_STATE:
        raise ValueError(f"state size N={N} > {MAX_STATE}")
    smem = 4 * (P * N + chunk * P + chunk * chunk + 3 * chunk)
    if smem > MAX_SMEM:
        raise ValueError(f"state + chunk need {smem} B of shared memory > {MAX_SMEM}")
    if not all(t.is_contiguous() for t in (x, loga, Bmat, C)):
        raise ValueError("x, loga, B and C must be contiguous")
    y = torch.empty_like(x)
    state = torch.empty((Bb, H, P, N), dtype=torch.float32, device=device)
    fn = _kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_CODES[x.dtype], x.data_ptr(), loga.data_ptr(), Bmat.data_ptr(), C.data_ptr(),
                y.data_ptr(), state.data_ptr(), Bb, T, H, P, N, chunk, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed for x {tuple(x.shape)} {x.dtype}, "
                           f"N {N}, chunk {chunk}: cudaError_t {rc}")
    ssd_scan.launches += 1
    return y, state


#: kernel launches since the last reset (set to 0 to reset)
ssd_scan.launches = 0
