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

Training differentiates the scan.  On the CPU autograd runs through the
plain version.  For CUDA tensors that need a gradient the call goes through
``_SsdScan``: its forward launches the same kernel, which then also writes
the state entering every chunk, (B, T/chunk, H, P, N) float32 — the chunk's
flow-out facet, one contiguous block per chunk — and saves them; its
backward launches the hand-written ``csrc/ssd_scan_bwd.cu``
(:func:`ssd_scan_bwd`) and returns dx, dloga, dB and dC: chunk-parallel
products (in bfloat16 on the tensor cores) around one cheap serial pass that
carries the state's gradient from the last chunk to the first (its design is
in the source's header note; :func:`backward_plan` reports its grids,
scratch and shared memory).  A call that needs no gradient (serving) launches the
scan alone, as before.

For tensors on the CPU the wrappers run the plain versions; for CUDA tensors
they launch the kernels or raise — they never fall back.  For ``meta``
tensors (a dry run's shapes) they make the kernels' checks, then propagate
shapes through the plain versions, the gradient included: shape
propagation only, nothing is computed.  A DTensor (which
reports its local device) raises: a sharded model gathers its parameters
where a layer reads them, so the kernels only ever see plain tensors.
``ssd_scan.launches`` and ``ssd_scan_bwd.launches`` count kernel launches
(the plain paths do not count).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from .ref import ssd_chunked_bwd_ref, ssd_chunked_ref

__all__ = ["ssd_scan", "ssd_scan_bwd", "launch_plan", "SsdPlan", "backward_plan",
           "SsdBwdPlan"]

_SOURCE = "ssd_scan"
_BWD_SOURCE = "ssd_scan_bwd"
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
    fn.argtypes = [_INT, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID,
                   _INT, _INT, _INT, _INT, _INT, _INT, _VOID]
    fn.restype = _INT
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    from repro_torch.kernels import _build

    fn = _build.library(_BWD_SOURCE).ssd_scan_bwd
    fn.argtypes = [_INT, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID,
                   _VOID, _VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT, _INT, _INT, _INT, _VOID]
    fn.restype = _INT
    return fn


#: threads per CTA of every backward launch; the p-tile and n-chunk of the
#: bf16 launches, the columns of dB / dC per cross CTA, the p-tile and
#: n-chunk of the f32 launches (``kThreads``, ``kPT``, ``kKN``, ``kNG``,
#: ``kFP``, ``kFN`` in the source)
BWD_THREADS = 256
_PT, _KN, _NG, _FP, _FN = 64, 128, 64, 32, 32
#: the backward's launches, in order
BWD_LAUNCHES = ("local", "pass", "head", "cross")


@dataclasses.dataclass(frozen=True)
class SsdBwdPlan:
    """One ``ssd_scan_bwd`` call: its four launches in order (``local``: U
    of every chunk, its decays and G^T; ``pass``: the state-passing
    recurrence; ``head``: dx and dloga per head and chunk; ``cross``: dB and
    dC per chunk, summed over the heads), each with its grid (x, y, 1) and
    dynamic shared memory per CTA (BWD_THREADS threads each), the route of
    the chunk products (``"mma"``: bf16 tensor cores; ``"fma"``: f32 FMAs),
    the scratch it allocates (dS_next of every chunk, G^T per chunk, each
    chunk and head's decay tables) and the per-chunk states the forward saved
    for it, in bytes."""

    grids: dict
    smem: dict
    route: str
    scratch: int
    saved: int

    @property
    def ctas(self) -> dict:
        return {k: math.prod(g) for k, g in self.grids.items()}


def _tab_floats(lp: int) -> int:
    """Floats of one (row, chunk, head) block of the tables scratch: the
    cumsum of the log-decays, the decay factors R, Q, exp(l_t), exp(l_L -
    l_t) (``lp`` each) and M (8 x 8): ``tab_floats`` of the source."""
    return 5 * lp + 64


def _bwd_smem(L: int, N: int, route: str) -> dict:
    """Shared memory per CTA of each launch: ``ssd_scan_bwd_smem`` of the
    source (its ``local_layout``, ``head_layout``, ``cross_layout`` and
    ``*_fma_floats``)."""
    if route == "fma":
        local = max(2 * L * (_NG + 1), L * (_FP + 1) + L * (_NG + 1) + _r16(L) + L)
        head = (L * (L + 1) + 4 * L * (_FP + 1) + 2 * _FP * (_FN + 1) + 3 * L + 32 * L + 4 * L
                + BWD_THREADS)
        cross = L * (L + 1) + 2 * L * (_FP + 1) + _FP * (_NG + 1) + L * (_NG + 1) + 2 * L
        return {"local": 4 * local, "pass": 0, "head": 4 * head, "cross": 4 * cross}
    lp, np_ = _r16(L), _r16(N)
    arr = lp * (np_ + 8) * 2
    ldp, ldn, nb = _PT + 8, _KN + 8, lp // 16
    local = max(2 * arr, arr + 2 * _PT * (lp + 8) * 2 + 2 * lp * 4 + lp * ldp * 2)
    head = lp * ldn * 2 + 2 * lp * ldp * 2 + 2 * _PT * ldn * 2 + 4 * (_tab_floats(lp) + 11 * lp)
    cross = (3 * lp * ldp * 2 + 2 * _PT * ldp * 2 + nb * (nb + 1) // 2 * 256 * 4
             + 4 * _tab_floats(lp))
    return {"local": local, "pass": 0, "head": head, "cross": cross}


def backward_plan(B: int, T: int, H: int, P: int, N: int, L: int,
                  dtype: torch.dtype = torch.bfloat16) -> SsdBwdPlan:
    """The launches ``ssd_scan_bwd`` makes for x (B, T, H, P), state size N
    and chunk L in ``dtype``: ``local`` over (H + 1) x T/L CTAs per row,
    ``pass`` one thread per 4 state elements (per element where P N is not a
    multiple of 4), ``head`` over H x T/L, ``cross`` over 2 ceil(N/64) x T/L;
    bfloat16 on the tensor cores, float32 on the FP32 pipes.  Mirrors the
    source's grids and ``ssd_scan_bwd_smem``.  Plain Python: the tests call
    it without a card."""
    if not 0 < L <= MAX_CHUNK:
        raise ValueError(f"chunk {L} outside (0, {MAX_CHUNK}]")
    if not 0 < N <= MAX_STATE:
        raise ValueError(f"state size N={N} outside (0, {MAX_STATE}]")
    if H > 65535 or B > 65535:
        raise ValueError(f"heads {H} and rows {B} must each be <= 65535")
    if T % L:
        raise ValueError(f"T={T} must divide by chunk={L}")
    if dtype not in _CODES:
        raise TypeError(f"no ssd_scan_bwd route for {dtype}")
    route = "mma" if dtype == torch.bfloat16 else "fma"
    nc, lp = T // L, _r16(L)
    per = 4 if P * N % 4 == 0 else 1
    grids = {"local": ((H + 1) * nc, B, 1),
             "pass": (-(-(H * P * N // per) // BWD_THREADS), B, 1),
             "head": (H * nc, B, 1),
             "cross": (2 * -(-N // _NG) * nc, B, 1)}
    states = 4 * B * nc * H * P * N
    return SsdBwdPlan(grids, _bwd_smem(L, N, route), route,
                      states + 4 * B * nc * lp * lp + 4 * B * nc * H * _tab_floats(lp), states)


def _plain(*ts) -> None:
    """Raise on a DTensor among ``ts`` (None entries skipped)."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in ts):
        raise TypeError("the SSD kernels take plain tensors, not DTensors: gather a sharded "
                        "operand first")


def _check(x, loga, Bmat, C, chunk) -> None:
    _plain(x, loga, Bmat, C)
    if x.dim() != 4 or loga.dim() != 3 or Bmat.dim() != 3 or C.shape != Bmat.shape:
        raise ValueError(f"want x (B,T,H,P), loga (B,T,H), B/C (B,T,N), got "
                         f"{tuple(x.shape)}, {tuple(loga.shape)}, {tuple(Bmat.shape)}, "
                         f"{tuple(C.shape)}")
    Bb, T, H, P = x.shape
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
    if device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"tensors must be on a CUDA device, the CPU or meta, got {device}")
    if device.type == "cpu":
        return
    if x.dtype not in _CODES or Bmat.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"x, B and C must share a dtype of {sorted(map(str, _CODES))}, got "
                        f"{x.dtype}, {Bmat.dtype}, {C.dtype}")
    if loga.dtype != torch.float32:
        raise TypeError(f"loga must be float32, got {loga.dtype}")
    if not all(t.is_contiguous() for t in (x, loga, Bmat, C)):
        raise ValueError("x, loga, B and C must be contiguous")


def _forward(x, loga, Bmat, C, chunk: int, save_states: bool):
    """One ``ssd_scan`` launch on CUDA tensors: (y, final state, the state
    entering every chunk or None)."""
    Bb, T, H, P = x.shape
    N = Bmat.shape[-1]
    plan = launch_plan(Bb, T, H, P, N, chunk, x.dtype)
    if plan.smem > MAX_SMEM:
        raise ValueError(f"state + chunk need {plan.smem} B of shared memory > {MAX_SMEM}")
    y = torch.empty_like(x)
    state = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    states = (torch.empty((Bb, T // chunk, H, P, N), dtype=torch.float32, device=x.device)
              if save_states else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(_CODES[x.dtype], x.data_ptr(), loga.data_ptr(), Bmat.data_ptr(),
                       C.data_ptr(), y.data_ptr(), state.data_ptr(),
                       None if states is None else states.data_ptr(), Bb, T, H, P, N, chunk,
                       stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed for x {tuple(x.shape)} {x.dtype}, "
                           f"N {N}, chunk {chunk}: cudaError_t {rc}")
    ssd_scan.launches += 1
    return y, state, states


class _SsdScan(torch.autograd.Function):
    """``ssd_scan`` on CUDA tensors that need a gradient: the forward kernel,
    which also saves the per-chunk states, and the backward kernel."""

    @staticmethod
    def forward(ctx, x, loga, Bmat, C, chunk):
        y, state, states = _forward(x, loga, Bmat, C, chunk, save_states=True)
        ctx.save_for_backward(x, loga, Bmat, C, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, loga, Bmat, C, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, dloga, dB, dC = ssd_scan_bwd(x, loga, Bmat, C, dy, dstate, chunk=ctx.chunk,
                                         states=states)
        return dx, dloga, dB, dC, None


def ssd_scan(
    x: torch.Tensor,  # (B, T, H, P)
    loga: torch.Tensor,  # (B, T, H) float32
    Bmat: torch.Tensor,  # (B, T, N)
    C: torch.Tensor,  # (B, T, N)
    *,
    chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan; returns (y (B,T,H,P), final state (B,H,P,N)).
    Differentiable: on CUDA tensors through ``_SsdScan`` (the backward
    kernel), on the CPU through the plain version."""
    _check(x, loga, Bmat, C, chunk)
    if x.device.type in ("cpu", "meta"):  # meta: shapes only (gradient too), nothing computed
        return ssd_chunked_ref(x, loga, Bmat, C, chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, loga, Bmat, C)):
        return _SsdScan.apply(x, loga, Bmat, C, chunk)
    return _forward(x, loga, Bmat, C, chunk, save_states=False)[:2]


#: kernel launches since the last reset (set to 0 to reset)
ssd_scan.launches = 0


def ssd_scan_bwd(
    x: torch.Tensor,
    loga: torch.Tensor,
    Bmat: torch.Tensor,
    C: torch.Tensor,
    dy: torch.Tensor,  # (B, T, H, P): the gradient of y
    dstate: torch.Tensor | None = None,  # (B, H, P, N): the final state's (None: zero)
    *,
    chunk: int = 128,
    states: torch.Tensor | None = None,  # (B, T/chunk, H, P, N) from the forward (CUDA)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The scan's gradient: (dx, dloga, dB, dC), dx/dB/dC in the inputs'
    dtype and dloga in float32.  For CUDA tensors one ``ssd_scan_bwd.cu``
    call (four launches on the current stream, :func:`backward_plan`) over
    the forward's saved per-chunk ``states``; for CPU tensors the plain
    version (autograd through ``ssd_chunked_ref``; ``states`` unused)."""
    _check(x, loga, Bmat, C, chunk)
    _plain(dy, dstate, states)
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} on {dy.device} does not match x "
                         f"{tuple(x.shape)} on {x.device}")
    if x.device.type in ("cpu", "meta"):  # meta: shapes only, nothing computed
        return ssd_chunked_bwd_ref(x, loga, Bmat, C, dy, dstate, chunk)
    Bb, T, H, P = x.shape
    N, nc = Bmat.shape[-1], T // chunk
    if states is None or states.shape != (Bb, nc, H, P, N) or states.dtype != torch.float32:
        raise ValueError(f"the backward kernel reads the forward's per-chunk states, float32 "
                         f"{(Bb, nc, H, P, N)}; got "
                         f"{None if states is None else (tuple(states.shape), states.dtype)}")
    if dstate is not None and (dstate.shape != (Bb, H, P, N) or dstate.device != x.device):
        raise ValueError(f"dstate {tuple(dstate.shape)} does not match {(Bb, H, P, N)}")
    plan = backward_plan(Bb, T, H, P, N, chunk, x.dtype)
    if max(plan.smem.values()) > MAX_SMEM:
        raise ValueError(f"the backward needs {plan.smem} B of shared memory > {MAX_SMEM}")
    dy = dy.to(x.dtype).contiguous()
    states = states.contiguous()
    if dstate is not None:
        dstate = dstate.to(torch.float32).contiguous()
    dx = torch.empty_like(x)
    dB, dC = torch.empty_like(Bmat), torch.empty_like(C)
    dloga = torch.empty_like(loga)
    lp = _r16(chunk)
    gram = torch.empty((Bb, nc, lp, lp), dtype=torch.float32, device=x.device)
    dstates = torch.empty_like(states)
    tabs = torch.empty((Bb, nc, H, _tab_floats(lp)), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _bwd_kernel()(_CODES[x.dtype], x.data_ptr(), loga.data_ptr(), Bmat.data_ptr(),
                           C.data_ptr(), states.data_ptr(), dy.data_ptr(),
                           None if dstate is None else dstate.data_ptr(), dx.data_ptr(),
                           dloga.data_ptr(), dB.data_ptr(), dC.data_ptr(), gram.data_ptr(),
                           dstates.data_ptr(), tabs.data_ptr(), Bb, T, H, P, N, chunk, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed for x {tuple(x.shape)} "
                           f"{x.dtype}, N {N}, chunk {chunk}: cudaError_t {rc}")
    ssd_scan_bwd.launches += 1
    return dx, dloga, dB, dC


#: kernel calls since the last reset (set to 0 to reset)
ssd_scan_bwd.launches = 0
