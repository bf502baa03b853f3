"""CUDA kernel: the chunked Mamba2 SSD scan (the wrapper around
``csrc/ssd_scan.cu``).

Replaces the reference package's Pallas kernel
``repro/kernels/ssd/ssd.py::ssd_scan`` (body ``_kernel``): the SSD recurrence
in chunks of ``chunk`` steps, the inter-chunk state carried in float32 as
the chunk's CFA flow-out facet.  Returns ``y (B, T, H, P)`` in ``x.dtype``
and the final state ``(B, H, P, N)`` in float32; needs ``T % chunk == 0``,
as the reference does.

At the serve shape the kernel is bounded by bytes once its chunk products
run on the tensor cores.  Its design (a grid of (ceil(P/16), H, B) CTAs, each
16 state rows of one head walking the chunks; in bfloat16 all four chunk
products on the tensor cores, as 16x16 units spread over 16 warps, with the
f32 operands split into hi/lo bf16 pairs; in float32 FP32 FMAs in the same
grid) is in the source's header
note; :func:`launch_plan` reports the grid and the shared memory.  It
matches the plain version
(:func:`~repro_torch.kernels.ssd.ref.ssd_chunked_ref`) to float rounding.

For tensors on the CPU the wrapper runs the plain version; for CUDA tensors
it launches the kernel or raises — it never falls back.
``ssd_scan.launches`` counts kernel launches (the plain path does not count).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from .ref import ssd_chunked_ref

__all__ = ["ssd_scan", "launch_plan", "SsdPlan"]

_SOURCE = "ssd_scan"
_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 128
MAX_STATE = 256
#: dynamic shared memory a block can use on sm_90
MAX_SMEM = 232448
#: state rows p per CTA; threads per CTA of the f32 and the bf16 route
#: (``kPB``, ``kThreads``, ``kMmaThreads`` in the source)
P_BLOCK = 16
THREADS = 256
MMA_THREADS = 512


@dataclasses.dataclass(frozen=True)
class SsdPlan:
    """One ``ssd_scan`` launch: its grid (blocks of P_BLOCK state rows,
    heads, rows) of CTAs of ``threads`` threads, the route of its chunk products
    (``"mma"``: bf16 tensor cores; ``"fma"``: f32 FMAs), the chunk and state
    padded to multiples of 16 (mma), the stages of the chunk's staging ring
    and the dynamic shared memory per CTA."""

    grid: tuple[int, int, int]
    route: str
    lp: int
    np_: int
    stages: int
    smem: int

    @property
    def ctas(self) -> int:
        return math.prod(self.grid)

    @property
    def threads(self) -> int:
        return MMA_THREADS if self.route == "mma" else THREADS

    @property
    def ctas_per_sm(self) -> int:
        """CTAs an SM holds by shared memory (1 KiB reserved per CTA) and threads."""
        return max(0, min((MAX_SMEM + 1024) // (self.smem + 1024), 2048 // self.threads))


def _r16(v: int) -> int:
    return -(-v // 16) * 16


def _mma_smem(L: int, N: int, stages: int) -> int:
    """``make_layout(L, N, stages).total`` of the source."""
    lp, np_ = _r16(L), _r16(N)
    ldc = np_ + 8
    stage = 2 * lp * ldc * 2 + lp * (P_BLOCK + 8) * 2 + lp * 4
    nb = lp // 16  # t-blocks: a y partial per (t-block, s-block <= it), and per t-block
    return (stages * stage + 4 * P_BLOCK * ldc * 2 + 2 * P_BLOCK * (lp + 8) * 2 + 4 * lp * 4
            + 256 + (nb * (nb + 1) // 2 + nb) * 256 * 4)


def launch_plan(B: int, T: int, H: int, P: int, N: int, L: int,
                dtype: torch.dtype = torch.bfloat16) -> SsdPlan:
    """The launch ``ssd_scan`` makes for x (B, T, H, P), state size N and
    chunk L in ``dtype``: 16 state rows per CTA, so ceil(P/16)·H·B CTAs;
    bfloat16 on the tensor cores, with two staging stages where they fit in
    shared memory; float32 on the FP32 pipes.  Plain Python: the tests call it
    without a card."""
    if not 0 < L <= MAX_CHUNK:
        raise ValueError(f"chunk {L} outside (0, {MAX_CHUNK}]")
    if not 0 < N <= MAX_STATE:
        raise ValueError(f"state size N={N} outside (0, {MAX_STATE}]")
    if H > 65535 or B > 65535:
        raise ValueError(f"heads {H} and rows {B} must each be <= 65535 (the grid's y and z)")
    grid = (-(-P // P_BLOCK), H, B)
    if dtype == torch.float32:
        smem = 4 * (N * P_BLOCK + L * P_BLOCK + L * L + 3 * L)
        return SsdPlan(grid, "fma", L, N, 1, smem)
    if dtype != torch.bfloat16:
        raise TypeError(f"no ssd_scan route for {dtype}")
    stages = 2 if _mma_smem(L, N, 2) <= MAX_SMEM else 1
    return SsdPlan(grid, "mma", _r16(L), _r16(N), stages, _mma_smem(L, N, stages))


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
    plan = launch_plan(Bb, T, H, P, N, chunk, x.dtype)
    if plan.smem > MAX_SMEM:
        raise ValueError(f"state + chunk need {plan.smem} B of shared memory > {MAX_SMEM}")
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
