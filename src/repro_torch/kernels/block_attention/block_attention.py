"""CUDA kernel: decode attention over the facet(block)-layout KV cache (the
wrapper around ``csrc/block_attention.cu``).

Replaces the reference package's Pallas kernel
``repro/kernels/block_attention/block_attention.py::decode_attention`` (body
``_kernel``): one GQA decode step, ``q (B, Hq, D)`` against a block-layout
cache ``(B, nb, Hkv, bs, D)`` whose ``(bs, D)`` extents are the contiguous
bursts of the CFA layout, masked at ``pos >= lengths[b]``.

The kernel is bounded by memory (the valid K/V prefix is read once for all
``Hq/Hkv`` query heads of a kv head).  Its design, in the source's header
note: split-K over fixed 128-position ranges of the cache's blocks (the
grid follows from the static shape; CTAs past a row's length exit), one
bulk copy (``cp.async.bulk``) per burst of K and of V into a two-stage
shared-memory ring completed on mbarriers, f32 online softmax on CUDA
cores, and the splits' partials merged in split order inside the same
launch by the last CTA of each (row, kv head).  :func:`launch_plan` is the
host's copy of that plan (grid, rows per staged sub-tile, shared memory).
It matches the plain version
(:func:`~repro_torch.kernels.block_attention.ref.decode_attention_ref` over
:func:`deblockify`) to float rounding: the sums run in another order.

The call reads no device data on the host and launches nothing but the
kernel: ``lengths`` may be int32 or int64 and broadcast (stride 0), the
partials come from ``torch.empty`` on the current stream and the combine's
ticket counters are allocated and zeroed once per device (the kernel leaves
them zero).  So a call can be captured in a CUDA graph.  Two calls must not
run at the same time on two streams of one device (they would share the
tickets); the port's paths make them on one stream.

For tensors on the CPU the wrapper runs the plain version; for CUDA tensors
it launches the kernel or raises — it never falls back.  For ``meta``
tensors (a dry run's shapes) it makes the kernel's checks, then propagates
shapes through the plain version: shape propagation only, nothing is
computed.  A DTensor raises: a sharded model gathers its parameters where a
layer reads them, so the kernel only ever sees plain tensors.
``decode_attention.launches`` counts kernel launches (the plain path does
not count).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .ref import decode_attention_ref, deblockify

__all__ = ["decode_attention", "launch_plan", "AttentionPlan"]

_SOURCE = "block_attention"
_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_I64 = ctypes.c_int64
#: dtype codes of the C interface
_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LEN_CODES = {torch.int32: 0, torch.int64: 1}
#: (q dtype, K/V dtype) pairs the kernel is built for
_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16)}
MAX_HEAD_DIM = 256
#: dynamic shared memory a block can use on sm_90
MAX_SMEM = 232448
#: positions per split (``kSplit`` in the source's note): a split lies in one block
SPLIT = 128
#: staged rows per sub-tile at most, and the byte budget of one K (or V) sub-tile
MAX_SUB, SUB_BYTES = 64, 16384
#: shared-memory ring depth (``kStages``)
STAGES = 2


class AttentionPlan(NamedTuple):
    """The kernel's launch at one shape: ``grid`` (splits, kv heads, rows),
    ``bs`` the block size, ``split`` positions per split, ``nspb`` splits
    per block, ``sub`` rows per staged sub-tile, ``smem`` dynamic shared
    bytes per CTA, ``bulk`` whether a K/V row is a whole number of 16-byte
    units (bulk copies; else word loads, given 16-byte aligned tensors)."""

    grid: tuple[int, int, int]
    bs: int
    split: int
    nspb: int
    sub: int
    smem: int
    bulk: bool

    def n_work(self, length: int) -> int:
        """Splits of a row that start below its length (clamped to the
        cache); at least 1, as in the kernel."""
        cap = self.grid[0] // self.nspb * self.bs
        n = max(0, min(int(length), cap))
        return max(1, n // self.bs * self.nspb + -(-(n % self.bs) // self.split))

    def working(self, lengths) -> int:
        """CTAs that do work for ``lengths`` (the others exit at once)."""
        return sum(self.n_work(n) for n in lengths) * self.grid[1]


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def launch_plan(B: int, Hq: int, Hkv: int, nb: int, bs: int, D: int,
                kv_esize: int) -> AttentionPlan:
    """The grid, sub-tile rows and shared memory of a call (the source's
    arithmetic): rows per sub-tile halve from 64 until one K sub-tile is at
    most 16 KiB, so the two-stage ring of K and V stays within 64 KiB
    (larger only when the combine's weights need more)."""
    G = Hq // Hkv
    split = min(SPLIT, bs)
    nspb = -(-bs // split)
    sub = MAX_SUB
    while sub > 8 and sub * D * kv_esize > SUB_BYTES:
        sub //= 2
    # the combine reuses the ring for (splits + 1) * G weights
    ring = max(2 * STAGES * _round16(sub * D * kv_esize), _round16(4 * (nb * nspb + 1) * G))
    smem = ring + 4 * (2 * G * D + G * sub + 3 * G)
    return AttentionPlan((nb * nspb, Hkv, B), bs, split, nspb, sub, smem,
                         (D * kv_esize) % 16 == 0)


@functools.lru_cache(maxsize=None)
def _kernel():
    from repro_torch.kernels import _build

    fn = _build.library(_SOURCE).decode_attention
    fn.argtypes = [_INT, _INT, _INT, _VOID, _VOID, _VOID, _VOID, _I64, _VOID, _VOID, _VOID,
                   _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _VOID]
    fn.restype = _INT
    return fn


#: device index -> the combine's ticket counters (uint32 as int32, zero between calls)
_TICKETS: dict[int, torch.Tensor] = {}


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    t = _TICKETS.get(device.index)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _TICKETS[device.index] = t
    return t


def decode_attention(
    q: torch.Tensor,  # (B, Hq, D)
    k_blocks: torch.Tensor,  # (B, nb, Hkv, bs, D) facet layout
    v_blocks: torch.Tensor,  # (B, nb, Hkv, bs, D)
    lengths: torch.Tensor,  # (B,) int — valid prefix length per row
) -> torch.Tensor:  # (B, Hq, D) in q.dtype
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in (q, k_blocks, v_blocks, lengths)):
        raise TypeError("decode_attention takes plain tensors, not DTensors: gather a sharded "
                        "operand first")
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
    if device.type not in ("cuda", "meta"):
        raise ValueError(f"tensors must be on a CUDA device, the CPU or meta, got {device}")
    if k_blocks.dtype != v_blocks.dtype or (q.dtype, k_blocks.dtype) not in _PAIRS:
        raise TypeError(f"the kernel takes (q, K/V) dtypes {sorted(map(str, _PAIRS))}, got "
                        f"{q.dtype}, {k_blocks.dtype}/{v_blocks.dtype}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {MAX_HEAD_DIM}")
    plan = launch_plan(B, Hq, Hkv, nb, bs, D, k_blocks.element_size())
    if plan.smem > MAX_SMEM:
        raise ValueError(f"{Hq // Hkv} query heads per kv head at D={D} need {plan.smem} B "
                         f"of shared memory > {MAX_SMEM}")
    if not all(t.is_contiguous() for t in (q, k_blocks, v_blocks)):
        raise ValueError("q, K and V must be contiguous")
    if device.type == "meta":  # shapes only, after the kernel's checks: nothing is computed
        return decode_attention_ref(q, deblockify(k_blocks), deblockify(v_blocks),
                                    lengths.to(device))
    if lengths.device != device:
        lengths = lengths.to(device)
    if lengths.dtype not in _LEN_CODES:
        lengths = lengths.to(torch.int32)
    G = Hq // Hkv
    out = torch.empty_like(q)
    part = torch.empty(B * Hkv * plan.grid[0] * G * (D + 2), dtype=torch.float32, device=device)
    tickets = _tickets(device, B * Hkv)
    fn = _kernel()
    stream = torch.cuda.current_stream(device).cuda_stream
    args = (_CODES[q.dtype], _CODES[k_blocks.dtype], _LEN_CODES[lengths.dtype], q.data_ptr(),
            k_blocks.data_ptr(), v_blocks.data_ptr(), lengths.data_ptr(), lengths.stride(0),
            out.data_ptr(), part.data_ptr(), tickets.data_ptr(), B, Hq, Hkv, nb, bs, D,
            plan.split, plan.sub, stream)
    if device.index == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(device):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(
            f"decode_attention kernel launch failed for q {tuple(q.shape)} {q.dtype}, "
            f"K/V {tuple(k_blocks.shape)} {k_blocks.dtype}: cudaError_t {rc}")
    decode_attention.launches += 1
    return out


#: kernel launches since the last reset (set to 0 to reset)
decode_attention.launches = 0
