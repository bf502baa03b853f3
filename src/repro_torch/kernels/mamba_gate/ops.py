"""CUDA kernel: the Mamba2 block's epilogue, forward and backward (the
wrapper around ``csrc/gated_rms_norm.cu``).

``gated_rms_norm(y, xh, z, D, norm)`` computes
``rms_norm((y + D xh) * silu(z), norm)`` — the D skip of the scan's input,
the SiLU gate and the RMSNorm that follow the SSD scan in the full-sequence
block — with D cast to the compute dtype and every step rounded where the
eager chain (:func:`~repro_torch.kernels.mamba_gate.ref.gated_rms_norm_ref`)
rounds it.  It replaces no TPU kernel: the reference package leaves this
step to XLA.  The eager chain is about 17 kernels forward and 30 backward
over (rows, H*P) tensors; the kernel reads y, xh and z once and writes the
output once (one launch), and its backward reads them with the output's
gradient and writes the gradients of y, xh (the D term) and z once, then
sums the gradients of D and of the norm's scale from per-CTA partials in a
fixed order (two launches, no atomics: two calls give the same bits).  The
design is in the source's header note; :func:`launch_plan` reports the
launch.

For tensors on the CPU the wrapper runs the plain version; for CUDA tensors
it launches the kernel or raises — it never falls back.  For ``meta``
tensors (a dry run's shapes) it makes the kernel's checks, then propagates
shapes through the plain version.  A CUDA call that needs a gradient goes
through ``_GatedRmsNorm``, whose forward also saves each row's rstd (4 bytes
a row) and whose backward is the backward kernel.
``gated_rms_norm.launches`` counts forward launches and
``gated_rms_norm_bwd.launches`` backward calls (the plain path counts
nothing).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .ref import gated_rms_norm_bwd_ref, gated_rms_norm_ref

__all__ = ["gated_rms_norm", "gated_rms_norm_bwd", "gated_rms_norm_ref",
           "gated_rms_norm_bwd_ref", "launch_plan", "GatePlan"]

_SOURCE = "gated_rms_norm"
_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: elements of a 16-byte vector
_VEC = {torch.float32: 4, torch.bfloat16: 8}
#: rms_norm's epsilon (``kernels.elementwise.rms_norm``'s default)
EPS = 1e-6
#: threads per CTA at most, and the passes over a row a thread may make
#: (``kMaxThreads`` and the CHUNKS instances in the source)
MAX_THREADS = 512
CHUNKS = (1, 2, 4)
#: persistent CTAs per SM of the backward, at most
BWD_CTAS_PER_SM = 4


@dataclasses.dataclass(frozen=True)
class GatePlan:
    """One row's work: ``threads`` threads (a multiple of 32), each taking
    ``chunks`` vectors of ``vec`` contiguous channels of one head (16 bytes
    a load)."""

    vec: int
    chunks: int
    threads: int


def launch_plan(HP: int, P: int, dtype: torch.dtype = torch.bfloat16) -> GatePlan:
    """The plan for rows of ``HP`` channels in heads of ``P``: vectors of 16
    bytes (P must be a multiple of one), the fewest passes over the row that
    need at most MAX_THREADS threads.  Plain Python: the tests call it
    without a card."""
    if dtype not in _CODES:
        raise TypeError(f"no gated_rms_norm route for {dtype}")
    vec = _VEC[dtype]
    if P <= 0 or HP <= 0 or HP % P or P % vec:
        raise ValueError(f"H*P={HP} must be a positive multiple of P={P}, and P of {vec} "
                         f"(16-byte vectors of {dtype} within one head)")
    for chunks in CHUNKS:
        threads = -(-HP // (vec * chunks))
        if threads <= MAX_THREADS:
            return GatePlan(vec, chunks, -(-threads // 32) * 32)
    raise ValueError(f"H*P={HP} exceeds the kernel's {MAX_THREADS} x {CHUNKS[-1]} x {vec} "
                     f"channels a row")


@functools.lru_cache(maxsize=None)
def _lib():
    from repro_torch.kernels import _build

    lib = _build.library(_SOURCE)
    lib.gated_rms_norm.argtypes = [_INT, _INT, _INT, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID,
                                   _VOID, _INT, _INT, _INT, ctypes.c_float, _VOID]
    lib.gated_rms_norm.restype = _INT
    lib.gated_rms_norm_bwd_occupancy.argtypes = [_INT, _INT, _INT, _INT, _INT]
    lib.gated_rms_norm_bwd_occupancy.restype = _INT
    lib.gated_rms_norm_bwd.argtypes = [_INT, _INT, _INT, _INT, _VOID, _VOID, _VOID, _VOID,
                                       _VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID,
                                       _VOID, _INT, _INT, _INT, _VOID]
    lib.gated_rms_norm_bwd.restype = _INT
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_ctas(device_index: int, code: int, plan: GatePlan, HP: int, P: int) -> int:
    """Persistent CTAs of the backward's first launch on this device: the
    SMs times the CTAs an SM holds at this plan, at most BWD_CTAS_PER_SM."""
    per_sm = _lib().gated_rms_norm_bwd_occupancy(code, plan.chunks, plan.threads, HP, P)
    if per_sm <= 0:
        raise RuntimeError(f"gated_rms_norm_bwd cannot launch {plan} for H*P={HP}, P={P}")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return sms * min(per_sm, BWD_CTAS_PER_SM)


def _check(y, xh, z, D, norm) -> None:
    if y.dim() != 4 or xh.shape != y.shape:
        raise ValueError(f"want y and xh (B,S,H,P) of one shape, got {tuple(y.shape)}, "
                         f"{tuple(xh.shape)}")
    B, S, H, P = y.shape
    if z.shape != (B, S, H * P) or D.shape != (H,) or norm.shape != (H * P,):
        raise ValueError(f"want z {(B, S, H * P)}, D {(H,)} and norm {(H * P,)} for y "
                         f"{tuple(y.shape)}, got {tuple(z.shape)}, {tuple(D.shape)}, "
                         f"{tuple(norm.shape)}")
    devices = {t.device for t in (y, xh, z, D, norm)}
    if len(devices) != 1:
        raise ValueError(f"y, xh, z, D and norm must share one device, got "
                         f"{sorted(map(str, devices))}")
    device = y.device
    if device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"tensors must be on a CUDA device, the CPU or meta, got {device}")
    if device.type == "cpu":
        return
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in (y, xh, z, D, norm)):
        raise TypeError("gated_rms_norm takes plain tensors, not DTensors: gather a sharded "
                        "operand first")
    if y.dtype not in _CODES or xh.dtype != y.dtype or z.dtype != y.dtype:
        raise TypeError(f"y, xh and z must share a dtype of {sorted(map(str, _CODES))}, got "
                        f"{y.dtype}, {xh.dtype}, {z.dtype}")
    if D.dtype != torch.float32 or norm.dtype != torch.float32:
        raise TypeError(f"D and norm must be float32, got {D.dtype}, {norm.dtype}")
    if not all(t.is_contiguous() for t in (y, xh, z, D, norm)):
        raise ValueError("y, xh, z, D and norm must be contiguous")
    launch_plan(H * P, P, y.dtype)  # raises for rows the kernel does not take


def _check_aligned(*ts) -> None:
    """Raise unless every row starts 16-byte aligned (the kernel's vectors)."""
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("gated_rms_norm's tensors must start 16-byte aligned")


def _forward(y, xh, z, D, norm, save_rstd: bool):
    """One forward launch on CUDA tensors: (out, rstd per row or None)."""
    B, S, H, P = y.shape
    rows, HP = B * S, H * P
    out = torch.empty_like(z)
    rstd = torch.empty((B, S), dtype=torch.float32, device=y.device) if save_rstd else None
    plan = launch_plan(HP, P, y.dtype)
    _check_aligned(y, xh, z, norm, out)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().gated_rms_norm(_CODES[y.dtype], plan.chunks, plan.threads,
                                   y.data_ptr(), xh.data_ptr(), z.data_ptr(), D.data_ptr(),
                                   norm.data_ptr(), out.data_ptr(),
                                   None if rstd is None else rstd.data_ptr(), rows, HP, P, EPS,
                                   stream)
    if rc != 0:
        raise RuntimeError(f"gated_rms_norm kernel launch failed for y {tuple(y.shape)} "
                           f"{y.dtype}, {plan}: cudaError_t {rc}")
    gated_rms_norm.launches += 1
    return out, rstd


class _GatedRmsNorm(torch.autograd.Function):
    """``gated_rms_norm`` on CUDA tensors that need a gradient: the forward
    kernel, which also saves rstd per row, and the backward kernel."""

    @staticmethod
    def forward(ctx, y, xh, z, D, norm):
        out, rstd = _forward(y, xh, z, D, norm, save_rstd=True)
        ctx.save_for_backward(y, xh, z, D, norm, rstd)
        return out

    @staticmethod
    def backward(ctx, dout):
        return gated_rms_norm_bwd(*ctx.saved_tensors, dout)


def gated_rms_norm(
    y: torch.Tensor,  # (B, S, H, P): the scan's output
    xh: torch.Tensor,  # (B, S, H, P): the scan's input
    z: torch.Tensor,  # (B, S, H*P): the gate's projection
    D: torch.Tensor,  # (H,) float32
    norm: torch.Tensor,  # (H*P,) float32
) -> torch.Tensor:
    """The block's epilogue, (B, S, H*P) in ``y``'s dtype.  Differentiable:
    on CUDA tensors through ``_GatedRmsNorm`` (the backward kernel), on the
    CPU through the plain version."""
    _check(y, xh, z, D, norm)
    if y.device.type in ("cpu", "meta"):  # meta: shapes only (gradient too), nothing computed
        return gated_rms_norm_ref(y, xh, z, D, norm)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (y, xh, z, D, norm)):
        return _GatedRmsNorm.apply(y, xh, z, D, norm)
    return _forward(y, xh, z, D, norm, save_rstd=False)[0]


#: kernel launches since the last reset (set to 0 to reset)
gated_rms_norm.launches = 0


def gated_rms_norm_bwd(
    y: torch.Tensor,
    xh: torch.Tensor,
    z: torch.Tensor,
    D: torch.Tensor,
    norm: torch.Tensor,
    rstd: torch.Tensor | None,  # (B, S) float32 from the forward (CUDA)
    dout: torch.Tensor,  # (B, S, H*P): the output's gradient
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The epilogue's gradient: (dy, dxh, dz, dD, dnorm), dxh the D term
    alone; dy, dxh and dz in the inputs' dtype, dD and dnorm in float32.  For
    CUDA tensors one ``gated_rms_norm_bwd`` call (two launches on the current
    stream) over the forward's saved ``rstd``; for CPU and meta tensors
    autograd through the plain version (``rstd`` unused)."""
    _check(y, xh, z, D, norm)
    if dout.shape != z.shape or dout.device != z.device:
        raise ValueError(f"dout {tuple(dout.shape)} on {dout.device} does not match z "
                         f"{tuple(z.shape)} on {z.device}")
    if y.device.type in ("cpu", "meta"):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (y, xh, z, D, norm)]
            return torch.autograd.grad(gated_rms_norm_ref(*inputs), inputs, dout)
    B, S, H, P = y.shape
    rows, HP = B * S, H * P
    if rstd is None or rstd.shape != (B, S) or rstd.dtype != torch.float32 or \
            not rstd.is_contiguous():
        raise ValueError(f"the backward kernel reads the forward's rstd, float32 {(B, S)}; got "
                         f"{None if rstd is None else (tuple(rstd.shape), rstd.dtype)}")
    dout = dout.to(y.dtype).contiguous()
    dy, dxh, dz = torch.empty_like(y), torch.empty_like(xh), torch.empty_like(z)
    dD, dnorm = torch.empty_like(D), torch.empty_like(norm)
    code = _CODES[y.dtype]
    plan = launch_plan(HP, P, y.dtype)
    _check_aligned(y, xh, z, dout, norm, dy, dxh, dz)
    with torch.cuda.device(y.device):
        ctas = min(rows, _bwd_ctas(torch.cuda.current_device(), code, plan, HP, P))
        part = torch.empty((ctas, HP + H), dtype=torch.float32, device=y.device)
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().gated_rms_norm_bwd(code, plan.chunks, plan.threads, ctas,
                                       y.data_ptr(), xh.data_ptr(), z.data_ptr(),
                                       dout.data_ptr(), D.data_ptr(), norm.data_ptr(),
                                       rstd.data_ptr(), dy.data_ptr(), dxh.data_ptr(),
                                       dz.data_ptr(), part.data_ptr(), dD.data_ptr(),
                                       dnorm.data_ptr(), rows, HP, P, stream)
    if rc != 0:
        raise RuntimeError(f"gated_rms_norm_bwd kernel launch failed for y {tuple(y.shape)} "
                           f"{y.dtype}, {plan}, {ctas} CTAs: cudaError_t {rc}")
    gated_rms_norm_bwd.launches += 1
    return dy, dxh, dz, dD, dnorm


#: kernel calls since the last reset (set to 0 to reset)
gated_rms_norm_bwd.launches = 0
