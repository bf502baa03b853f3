"""CUDA kernel: CFA stencil tile executor (the wrapper around ``csrc/stencil_tiles.cu``).

Replaces the reference package's Pallas kernel
``repro/kernels/stencil/stencil.py::execute_tiles`` (body ``_tile_kernel``):
given a batch of halo buffers ``(B, w0+t0, .., w_{d-1}+t_{d-1})`` it runs
the program's plane recurrence for ``t0`` planes and returns the
``(B, t0, .., t_{d-1})`` interiors.  One launch per call: the ``cuda``
backend calls it once per anti-diagonal wave.

The kernel is bounded by memory traffic, not arithmetic; its design (one
CTA per tile, planes in order, previous planes read back from the output)
and the reasons are in the source's header note.  It is bit-exact against
the plain version (:func:`~repro_torch.kernels.stencil.ref.execute_tiles_ref`)
on the card: explicitly rounded intrinsics, no FMA contraction, terms in
the order of ``programs.term_table``.

For a tensor on the CPU the wrapper runs the plain version; for a CUDA
tensor it launches the kernel or raises — it never falls back.
``execute_tiles.launches`` counts kernel launches (the plain path does not
count).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.cfa.programs import get_program, term_table

from .ref import execute_tiles_ref

__all__ = ["execute_tiles"]

_SOURCE = "stencil_tiles"
_VOID = ctypes.c_void_p
_INT = ctypes.c_int


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
                   _INT, _INT, _INT, _VOID, _VOID, _VOID, _VOID]
    fn.restype = _INT
    return fn


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def execute_tiles(
    program_name: str,
    halos: torch.Tensor,  # (B, w0+t0, .., w_{d-1}+t_{d-1})
    tile: tuple[int, ...],
) -> torch.Tensor:  # (B, t0, .., t_{d-1})
    """Run the tile executor over a batch of gathered halo buffers.

    Dimension-generic: ``tile`` has one entry per iteration-space axis
    (time first), so 2-D (``heat1d``), 3-D (Table I) and 4-D (``heat3d``)
    programs share this path.
    """
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
    if halos.device.type == "cpu":
        return execute_tiles_ref(program, halos, tile)
    if halos.device.type != "cuda":
        raise ValueError(f"halos must be on a CUDA device or the CPU, got {halos.device}")
    if not halos.is_contiguous():
        raise ValueError("halos must be contiguous")
    B = halos.shape[0]
    out = torch.empty((B, *tile), dtype=halos.dtype, device=halos.device)
    if B == 0:
        return out
    combine, centre, n, depth, offs, values = _packed_terms(program.name)
    pad = 3 - (d - 1)
    ext = np.asarray((1,) * pad + hshape[1:], np.int32)
    wid = np.asarray((0,) * pad + tuple(w[1:]), np.int32)
    fn = _kernel()
    with torch.cuda.device(halos.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(halos.element_size(), halos.data_ptr(), out.data_ptr(), B,
                w[0], tile[0], _ptr(ext), _ptr(wid), combine, centre, n,
                _ptr(depth), _ptr(offs), _ptr(values), stream)
    if rc != 0:
        raise RuntimeError(
            f"stencil_tiles kernel launch failed for {program_name} "
            f"(B={B}, halo {hshape}, {halos.dtype}): cudaError_t {rc}"
        )
    execute_tiles.launches += 1
    return out


#: kernel launches since the last reset (set to 0 to reset)
execute_tiles.launches = 0
