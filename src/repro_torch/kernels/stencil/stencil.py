"""CUDA kernel: CFA stencil tile executor (the wrapper around ``csrc/stencil_tiles.cu``).

Replaces the reference package's Pallas kernel
``repro/kernels/stencil/stencil.py::execute_tiles`` (body ``_tile_kernel``):
given a batch of halo buffers ``(B, w0+t0, .., w_{d-1}+t_{d-1})`` it runs
the program's plane recurrence for ``t0`` planes and returns the
``(B, t0, .., t_{d-1})`` interiors.  One launch per call: the ``cuda``
backend calls it once per anti-diagonal wave.

The kernel is bounded by memory traffic, not arithmetic.  Its design (a
thread-block cluster of ``k`` CTAs per tile, each CTA a strip of the tile
with a ring of planes in shared memory, the strip's boundary rows handed to
the next CTA through distributed shared memory) is in the source's header
note; :func:`launch_plan` picks the split axis, ``k`` and the planes loaded
ahead, and reports the grid, the cluster and the shared memory.  The kernel
is bit-exact against the plain version
(:func:`~repro_torch.kernels.stencil.ref.execute_tiles_ref`) on the card:
explicitly rounded intrinsics, no FMA contraction, terms in the order of
``programs.term_table``.

For a tensor on the CPU the wrapper runs the plain version; for a CUDA
tensor it launches the kernel or raises — it never falls back.
``execute_tiles.launches`` counts kernel launches (the plain path does not
count).  The checks and the packing of a call (:func:`_check`) are apart
from the launch (:func:`_launch`), so that the per-port wrapper checks once
per call and then launches once per port.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.core.cfa.programs import (COMBINE_GOL, COMBINE_MAXPLUS, COMBINE_SUM,
                                           get_program, term_table)

from .ref import execute_tiles_ref

__all__ = ["execute_tiles", "launch_plan", "LaunchPlan"]

_SOURCE = "stencil_tiles"
_VOID = ctypes.c_void_p
_INT = ctypes.c_int
#: the H100 SXM's streaming multiprocessors, and the CTAs per SM a wave aims
#: at (two: at 64 tiles of 64^3, one per SM (k = 3) ran 4.7 % slower than
#: k = 5 in ``chip_smoke.py``'s split sweep on an NVIDIA H100 80GB HBM3 at
#: 700 W)
N_SM = 132
CTAS_PER_SM = 2
#: threads per CTA (``kThreads`` in the source); a thread takes two points
#: of a plane per step
THREADS = 256
#: points of a plane a CTA holds at least: below it a further CTA per tile
#: saves less than its cluster barrier per plane costs (``chip_smoke.py``'s
#: split sweep times every k at the paths' shapes)
MIN_CTA_POINTS = 1024
#: CTAs per tile at most (the portable cluster size)
MAX_CLUSTER = 8
#: planes loaded ahead at most (``kMaxAhead``), unless all of them are
MAX_AHEAD = 7
#: dynamic shared memory a block can use on sm_90
MAX_SMEM = 232448
#: the shared memory up to which more planes are loaded ahead (two CTAs per SM)
AHEAD_SMEM = MAX_SMEM // 2 - 1024
#: the (combine, term count) pairs the source has a kernel for: those of the
#: programs' tables (``programs.term_table``), their terms unrolled
KERNEL_TABLES = frozenset({(COMBINE_SUM, 3), (COMBINE_SUM, 5), (COMBINE_SUM, 7),
                           (COMBINE_SUM, 9), (COMBINE_SUM, 25), (COMBINE_MAXPLUS, 7),
                           (COMBINE_GOL, 9)})


@functools.lru_cache(maxsize=None)
def _packed_terms(name: str) -> tuple:
    """(combine, centre, n, depth i32[n], offsets i32[n*3], values f64[n]) —
    spatial offsets padded to three axes at the front."""
    tt = term_table(name)
    n = len(tt.depth)
    offs = np.zeros((n, 3), np.int32)
    for k, o in enumerate(tt.offsets):
        offs[k, 3 - len(o):] = o
    return (tt.combine, tt.centre, n, np.asarray(tt.depth, np.int32),
            np.ascontiguousarray(offs.ravel()), np.asarray(tt.values, np.float64))


@functools.lru_cache(maxsize=None)
def _kernel():
    from repro_torch.kernels import _build

    lib = _build.library(_SOURCE)
    fn = lib.stencil_tiles
    fn.argtypes = [_INT, _VOID, _VOID, _INT, _INT, _INT, _VOID, _VOID,
                   _INT, _INT, _INT, _VOID, _VOID, _VOID, _INT, _INT, _INT, _VOID]
    fn.restype = _INT
    return fn


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One ``stencil_tiles`` launch: each tile a cluster of ``k`` CTAs, each
    CTA ``strip`` interior rows of the tile along padded spatial axis
    ``split`` (the last CTA may hold fewer), with a ring of ``ring`` =
    w0 + 1 + ``ahead`` plane slots of extents ``slot`` in shared memory."""

    split: int
    k: int
    strip: int
    ahead: int
    ring: int
    slot: tuple[int, int, int]
    smem: int  # dynamic shared memory per CTA, bytes: the ring, then the halo-part list
    ctas: int  # B * k
    halo_parts: int  # elements of a plane's slot copied from the halo buffer (first CTA)

    @property
    def ctas_per_sm(self) -> int:
        """CTAs an SM holds by shared memory (1 KiB reserved per CTA) and threads."""
        by_smem = (MAX_SMEM + 1024) // (self.smem + 1024)
        return max(0, min(by_smem, 2048 // THREADS))


def _padded(program, tile) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(interior extents, halo widths) of the three padded spatial axes."""
    w = program.widths
    pad = 3 - (len(tile) - 1)
    return (1,) * pad + tuple(tile[1:]), (0,) * pad + tuple(w[1:])


def _halo_parts(w, slot) -> int:
    """``halo_part_count`` of the source: the first CTA's low-side halo of
    every axis, as disjoint boxes of its slot."""
    lo, n = [0, 0, 0], 0
    for a in range(3):
        if w[a] > 0:
            n += math.prod((w[a] if c == a else slot[c]) - lo[c] for c in range(3))
            lo[a] = w[a]
    return n


@functools.lru_cache(maxsize=None)
def _plan(name: str, B: int, tile: tuple[int, ...], esize: int,
          k: int | None = None) -> LaunchPlan:
    program = get_program(name)
    t, w = _padded(program, tile)
    w0, t0 = program.widths[0], tile[0]
    split = max(range(3), key=lambda a: (t[a], -a))  # the longest axis, the outermost on ties
    want = min(MAX_CLUSTER, max(1, -(-CTAS_PER_SM * N_SM // max(B, 1))),
               max(1, math.prod(t) // MIN_CTA_POINTS))

    def fits(k: int) -> LaunchPlan | None:
        strip = -(-t[split] // k)
        if (k - 1) * strip >= t[split] or (k > 1 and strip < w[split]):
            return None
        slot = tuple(w[a] + (strip if a == split else t[a]) for a in range(3))
        per_slot = math.prod(slot) * esize
        parts = _halo_parts(w, slot)

        def smem(ring: int) -> int:
            return -(-ring * per_slot // 16) * 16 + 8 * parts

        if smem(w0 + 1) > MAX_SMEM:
            return None
        if smem(w0 + t0) <= AHEAD_SMEM:  # a slot per plane: all halo parts up front
            ahead = t0 - 1
        else:
            ahead = 0
            while ahead < min(MAX_AHEAD, t0 - 1) and smem(w0 + 2 + ahead) <= AHEAD_SMEM:
                ahead += 1
        ring = w0 + 1 + ahead
        return LaunchPlan(split, k, strip, ahead, ring, slot, smem(ring), B * k, parts)

    if k is not None:
        plan = fits(k) if 1 <= k <= MAX_CLUSTER else None
        if plan is None:
            raise ValueError(f"{name} tile {tile}: no split into {k} strips (at most "
                             f"{MAX_CLUSTER}, each at least the halo width {w[split]}, within "
                             f"{MAX_SMEM} B of shared memory)")
        return plan
    # enough CTAs to put CTAS_PER_SM on every SM, as few per tile as give
    # that, none with fewer than MIN_CTA_POINTS points of a plane; more if a
    # ring does not fit
    for k in (*range(want, 0, -1), *range(want + 1, MAX_CLUSTER + 1)):
        plan = fits(k)
        if plan is not None:
            return plan
    raise ValueError(f"{name} tile {tile}: no split of the tile into at most {MAX_CLUSTER} "
                     f"strips fits {MAX_SMEM} B of shared memory per CTA")


def launch_plan(program: str, B: int, tile: tuple[int, ...],
                dtype: torch.dtype = torch.float32, k: int | None = None) -> LaunchPlan:
    """The launch ``execute_tiles`` makes for ``B`` tiles of ``tile`` in
    ``dtype``: the split axis (the longest padded spatial axis), ``k`` (the
    fewest CTAs per tile that put two CTAs on each of the card's 132 SMs, at most 8,
    none with fewer than MIN_CTA_POINTS points of a plane, each strip at
    least the split axis's halo width so that only the next CTA reads it),
    and as many planes loaded ahead as keep two CTAs per SM (all of them,
    ``ahead = t0 - 1``, where a slot per plane fits).  ``k`` forces
    the CTAs per tile (the checks use it to drive every split; raises where
    the tile does not split so).  Plain Python: the tests call it without a
    card."""
    esize = torch.empty((), dtype=dtype).element_size()
    return _plan(get_program(program).name, int(B), tuple(int(t) for t in tile), esize,
                 None if k is None else int(k))


@dataclasses.dataclass(frozen=True)
class _Call:
    """A checked and packed call: what the launch needs beyond the tensors."""

    program: object
    tile: tuple[int, ...]
    args: tuple  # (w0, t0, ext, wid, combine, centre, n, depth, offs, values)


def _check(program_name: str, halos: torch.Tensor, tile, out: torch.Tensor | None) -> _Call:
    """Validate a call and pack its arguments (once per call)."""
    program = get_program(program_name)
    w = program.widths
    tile = tuple(int(t) for t in tile)
    d = len(tile)
    if program.ndim != d:
        raise ValueError(f"{program_name} is {program.ndim}-D, tile is {d}-D")
    hshape = tuple(w[a] + tile[a] for a in range(d))
    if halos.dim() != d + 1 or tuple(halos.shape[1:]) != hshape:
        raise ValueError(f"halos must be (B, {hshape}), got {tuple(halos.shape)}")
    if halos.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"halos must be float32 or float64, got {halos.dtype}")
    B = halos.shape[0]
    if out is not None and (tuple(out.shape) != (B, *tile) or out.dtype != halos.dtype
                            or out.device != halos.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {halos.dtype} tensor of shape "
                         f"{(B, *tile)} on {halos.device}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    if halos.device.type not in ("cpu", "cuda"):
        raise ValueError(f"halos must be on a CUDA device or the CPU, got {halos.device}")
    if halos.device.type == "cuda" and not halos.is_contiguous():
        raise ValueError("halos must be contiguous")
    combine, centre, n, depth, offs, values = _packed_terms(program.name)
    t, wid = _padded(program, tile)
    ext = np.asarray([a + b for a, b in zip(t, wid)], np.int32)
    return _Call(program, tile, (w[0], tile[0], ext, np.asarray(wid, np.int32), combine,
                                 centre, n, depth, offs, values))


def _launch(call: _Call, halos: torch.Tensor, out: torch.Tensor,
            plan: LaunchPlan | None = None) -> None:
    """Launch the kernel on the current stream over ``halos`` (contiguous,
    on a CUDA device) into ``out``, by ``plan`` (default: :func:`launch_plan`'s);
    raises on a refused launch."""
    B = halos.shape[0]
    if B == 0:
        return
    if plan is None:
        plan = _plan(call.program.name, B, call.tile, halos.element_size())
    w0, t0, ext, wid, combine, centre, n, depth, offs, values = call.args
    if (combine, n) not in KERNEL_TABLES:
        raise ValueError(f"{call.program.name}: no stencil_tiles kernel for a table of {n} "
                         f"terms with combine mode {combine}")
    fn = _kernel()
    dev = halos.device
    switch = dev.index is not None and dev.index != torch.cuda.current_device()
    with torch.cuda.device(dev) if switch else contextlib.nullcontext():
        rc = fn(halos.element_size(), halos.data_ptr(), out.data_ptr(), B, w0, t0,
                _ptr(ext), _ptr(wid), combine, centre, n, _ptr(depth), _ptr(offs),
                _ptr(values), plan.split, plan.k, plan.ahead,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"stencil_tiles kernel launch failed for {call.program.name} (B={B}, halo "
            f"{tuple(halos.shape[1:])}, {halos.dtype}, plan {plan}): cudaError_t {rc}"
        )
    execute_tiles.launches += 1


def execute_tiles(
    program_name: str,
    halos: torch.Tensor,  # (B, w0+t0, .., w_{d-1}+t_{d-1})
    tile: tuple[int, ...],
    *,
    out: torch.Tensor | None = None,  # (B, t0, .., t_{d-1}), written in place
) -> torch.Tensor:  # (B, t0, .., t_{d-1})
    """Run the tile executor over a batch of gathered halo buffers.

    Dimension-generic: ``tile`` has one entry per iteration-space axis
    (time first), so 2-D (``heat1d``), 3-D (Table I) and 4-D (``heat3d``)
    programs share this path.  ``out`` (contiguous, the halos' dtype and
    device) receives the interiors instead of a new tensor.
    """
    call = _check(program_name, halos, tile, out)
    if halos.device.type == "cpu":
        got = execute_tiles_ref(call.program, halos, call.tile)
        return got if out is None else out.copy_(got)
    if out is None:
        out = torch.empty((halos.shape[0], *call.tile), dtype=halos.dtype, device=halos.device)
    _launch(call, halos, out)
    return out


#: kernel launches since the last reset (set to 0 to reset)
execute_tiles.launches = 0
