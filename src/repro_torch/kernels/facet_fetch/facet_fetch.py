"""CUDA kernel: the CFA read engine (the wrapper around ``csrc/facet_fetch.cu``).

Replaces the reference package's Pallas kernel
``repro/kernels/facet_fetch/facet_fetch.py::fetch_interior_halos`` (bodies
``_kernel`` and ``_kernel_irredundant``): it assembles the halo buffer of
every interior tile of a 3-D CFA facet family from facet blocks — the
paper's burst read, each facet block one contiguous extent.  Under
``storage="irredundant"`` it takes the owner-facet indirection over
deduplicated facet arrays, so the result equals the redundant fetch over
the redundant (rehydrated) arrays.

The kernel is pure data movement, bounded by memory.  Its design, in the
source's header note, is the JAX kernel's plan on Hopper: one CTA per
interior tile; the tile's facet blocks, with the pairs that are adjacent in
the facet array merged, copied into shared memory by one ``cp.async.bulk``
each (4 bursts redundant, 7 irredundant; a burst that is not 16-byte
aligned takes word loads in the same kernel); the halo buffer assembled
from there by the owner rule and written with 16-byte stores.
:func:`burst_plan` is the host's half of the addressing: per burst the
facet, the start of its first block as ``c + q . s`` over the tile
coordinates, the part copied and its place in shared memory, from the
facets' shapes (:func:`_strides`).  It is bit-exact against the plain
version (:func:`~repro_torch.kernels.facet_fetch.ref.fetch_interior_halos_ref`)
by construction.

For facets on the CPU the wrapper runs the plain version; for CUDA tensors
it launches the kernel or raises — it never falls back.
``fetch_interior_halos.launches`` counts kernel launches (the plain path
does not count).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.cfa.facets import row_major_strides

from .ref import _assemble_interior, fetch_geometry

__all__ = ["fetch_interior_halos", "burst_plan", "burst_paths"]

_SOURCE = "facet_fetch"
_VOID = ctypes.c_void_p
_INT = ctypes.c_int
#: dynamic shared memory a CTA of the kernel may stage (``kMaxSmem``)
MAX_STAGED = 232448 - 1024


@functools.lru_cache(maxsize=None)
def _kernel():
    from repro_torch.kernels import _build

    lib = _build.library(_SOURCE)
    fn = lib.facet_fetch
    fn.argtypes = [_INT, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID]
    fn.restype = _INT
    return fn


def _strides(specs, facets) -> tuple[np.ndarray, np.ndarray]:
    """(base[3], outer[3][3]), int64, facet first: where each facet array's
    tile row 0 starts (facet_0's skips the virtual live-in row) and the
    element stride of its tile coordinate on each canonical axis, from its
    FacetSpec."""
    base = np.zeros(3, np.int64)
    outer = np.zeros((3, 3), np.int64)
    for k, spec in specs.items():
        s = row_major_strides(tuple(facets[k].shape))
        for pos, a in enumerate(spec.outer_axes):
            outer[k, a] = s[pos]
        if k == 0:
            base[0] = outer[0, 0]  # tile row q0 lives at facet_0 row q0 + 1
    return base, outer


def _block_slots(storage: str, w, t) -> list[tuple[int, tuple[int, int, int], int, int]]:
    """The kernel's bursts in slot order: (facet, tile offset d of the
    slot's first block from q, start of the copied part within the slot,
    its length), in elements.  A pair slot holds two blocks adjacent in the
    facet array (facet_0 along tile axis 1, facet_1 along axis 2); only the
    tail of its first block that the halo uses is copied."""
    (w0, w1, w2), (t0, t1, t2) = w, t
    b0, b1, b2 = t1 * t2 * w0, t2 * t0 * w1, t0 * t1 * w2
    tail0, tail1 = (t1 - w1) * t2 * w0, (t2 - w2) * t0 * w1
    slots = [(0, (-1, -1, 0), tail0, w1 * t2 * w0 + b0),    # time halo + x0/x1 corner
             (0, (-1, -1, -1), tail0, w1 * t2 * w0 + b0),   # x0/x2 corner + S3
             (1, (0, -1, -1), tail1, w2 * t0 * w1 + b1),    # x1 halo + x1/x2 corner
             (2, (0, 0, -1), 0, b2)]                        # x2 halo
    if storage == "irredundant":  # the owner blocks
        slots += [(0, (0, -1, 0), tail0, w1 * t2 * w0),
                  (0, (0, -1, -1), tail0, w1 * t2 * w0 + b0),
                  (1, (0, 0, -1), tail1, w2 * t0 * w1)]
    return slots


def burst_plan(geo, facets, storage: str, esize: int) -> tuple[np.ndarray, int]:
    """(slots, staged bytes): per burst, int64 ``[facet, c, s0, s1, s2,
    offset in shared memory (bytes), start, len]`` — the slot's first block
    starts at element ``c + q0 s0 + q1 s1 + q2 s2`` of its facet array for
    tile ``q`` — and the shared memory a CTA stages (0 when the bursts
    exceed ``MAX_STAGED``: the kernel then reads them in place)."""
    base, outer = _strides(geo.specs, facets)
    (w0, w1, w2), (t0, t1, t2) = geo.w, geo.t
    if outer[0, 1] != t1 * t2 * w0 or outer[1, 2] != t2 * t0 * w1:
        raise ValueError("facet_0's blocks must be adjacent along tile axis 1 and facet_1's "
                         "along axis 2 (the paper's default layout)")
    rows, off = [], 0
    for k, d, start, length in _block_slots(storage, geo.w, geo.t):
        c = int(base[k]) + sum(int(d[a]) * int(outer[k, a]) for a in range(3))
        rows.append([k, c, *(int(x) for x in outer[k]), off, start, length])
        off += -(-length * esize // 16) * 16
    return np.asarray(rows, np.int64), (off if off <= MAX_STAGED else 0)


def burst_paths(geo, facets, storage: str) -> dict:
    """How the kernel copies each burst of every tile, as it decides: by one
    bulk copy when the source address and the size are multiples of 16
    bytes, else by word loads; both counts over all tiles and bursts, with
    the bursts per tile and the staged bytes per CTA."""
    esize = facets[0].element_size()
    slots, smem = burst_plan(geo, facets, storage, esize)
    q = np.stack(np.meshgrid(*(np.arange(1, n + 1) for n in geo.g), indexing="ij"), -1)
    q = q.reshape(-1, 3)
    bulk = word = 0
    for k, c, s0, s1, s2, _, start, length in slots.tolist():
        addr = facets[k].data_ptr() + (c + q @ np.array([s0, s1, s2]) + start) * esize
        ok = (addr % 16 == 0) & (length * esize % 16 == 0)
        n_ok = int(ok.sum()) if smem else 0
        bulk, word = bulk + n_ok, word + len(q) - n_ok
    return {"bursts_per_tile": len(slots), "bulk": bulk, "word": word, "staged_bytes": smem,
            "tiles": len(q)}


def fetch_interior_halos(
    program_name: str,
    facets: dict,  # CFAPipeline facet tensors (facet_0 includes the virtual row)
    space: tuple[int, int, int],
    tile: tuple[int, int, int],
    *,
    storage: str = "redundant",
) -> torch.Tensor:
    """Halo buffers for all interior tiles, gathered block-wise.

    Returns (n0-1, n1-1, n2-1, w0+t0, w1+t1, w2+t2) on the facets' device;
    entry (i, j, k) corresponds to tile (i+1, j+1, k+1).
    ``storage="irredundant"`` takes the owner-facet indirection over
    deduplicated facet arrays; the result is identical to the redundant
    fetch over redundant arrays.  The facets must be in the paper's default
    layout at ``tile`` (the shapes are checked).
    """
    geo = fetch_geometry(program_name, facets, space, tile, storage)
    f0, f1, f2 = facets[0], facets[1], facets[2]
    devices = {f.device for f in (f0, f1, f2)}
    if len(devices) != 1:
        raise ValueError(f"facets must share one device, got {sorted(map(str, devices))}")
    device = f0.device
    if device.type == "cpu":
        return _assemble_interior(f0, f1, f2, geo.w, geo.t, geo.g, storage)
    if device.type != "cuda":
        raise ValueError(f"facets must be on a CUDA device or the CPU, got {device}")
    if f0.element_size() not in (4, 8):
        raise TypeError(f"the kernel copies 4- or 8-byte elements, got {f0.dtype}")
    if not all(f.is_contiguous() for f in (f0, f1, f2)):
        raise ValueError("facets must be contiguous")
    (w0, w1, w2), (t0, t1, t2), g = geo.w, geo.t, geo.g
    out = torch.empty((*g, w0 + t0, w1 + t1, w2 + t2), dtype=f0.dtype, device=device)
    slots, smem = burst_plan(geo, facets, storage, f0.element_size())
    ints = np.asarray((*g, *geo.w, *geo.t, storage == "irredundant", smem), np.int32)
    fn = _kernel()
    stream = torch.cuda.current_stream(device).cuda_stream
    args = (f0.element_size(), f0.data_ptr(), f1.data_ptr(), f2.data_ptr(), out.data_ptr(),
            ints.ctypes.data, slots.ctypes.data, stream)
    if device.index == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(device):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(
            f"facet_fetch kernel launch failed for {program_name} (space "
            f"{tuple(space)}, tile {geo.t}, {storage}, {f0.dtype}): cudaError_t {rc}"
        )
    fetch_interior_halos.launches += 1
    return out


#: kernel launches since the last reset (set to 0 to reset)
fetch_interior_halos.launches = 0
