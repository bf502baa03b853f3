"""CUDA kernel: the CFA read engine (the wrapper around ``csrc/facet_fetch.cu``).

Replaces the reference package's Pallas kernel
``repro/kernels/facet_fetch/facet_fetch.py::fetch_interior_halos`` (bodies
``_kernel`` and ``_kernel_irredundant``): it assembles the halo buffer of
every interior tile of a 3-D CFA facet family from facet blocks — the
paper's burst read, each facet block one contiguous extent.  Under
``storage="irredundant"`` it takes the owner-facet indirection over
deduplicated facet arrays, so the result equals the redundant fetch over
the redundant (rehydrated) arrays.

The kernel is pure data movement, bounded by memory; its design (one CTA
per tile and halo plane, one writer per element, the source facet chosen
per element by the owner rule, word copies) is in the source's header note.
It is bit-exact against the plain version
(:func:`~repro_torch.kernels.facet_fetch.ref.fetch_interior_halos_ref`) by
construction.

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

__all__ = ["fetch_interior_halos"]

_SOURCE = "facet_fetch"
_VOID = ctypes.c_void_p
_INT = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _kernel():
    from repro_torch.kernels import _build

    lib = _build.library(_SOURCE)
    fn = lib.facet_fetch
    fn.argtypes = [_INT, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID]
    fn.restype = _INT
    return fn


def _strides(specs, facets) -> np.ndarray:
    """base[3], outer[3][3], inner[3][3] (int64, facet first): the element
    strides of each facet array's tile and intra-tile coordinates per
    canonical axis, from its FacetSpec; facet_0's base skips the virtual
    live-in row."""
    base = np.zeros(3, np.int64)
    outer = np.zeros((3, 3), np.int64)
    inner = np.zeros((3, 3), np.int64)
    for k, spec in specs.items():
        s = row_major_strides(tuple(facets[k].shape))
        n_outer = len(spec.outer_axes)
        for pos, a in enumerate(spec.outer_axes):
            outer[k, a] = s[pos]
        for pos, a in enumerate(spec.inner_axes):
            inner[k, a] = s[n_outer + pos]
        if k == 0:
            base[0] = outer[0, 0]  # tile row q0 lives at facet_0 row q0 + 1
    return np.concatenate([base, outer.ravel(), inner.ravel()])


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
    ints = np.asarray((*g, *geo.w, *geo.t, storage == "irredundant"), np.int32)
    strides = _strides(geo.specs, facets)
    fn = _kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(f0.element_size(), f0.data_ptr(), f1.data_ptr(), f2.data_ptr(),
                out.data_ptr(), ints.ctypes.data, strides.ctypes.data, stream)
    if rc != 0:
        raise RuntimeError(
            f"facet_fetch kernel launch failed for {program_name} (space "
            f"{tuple(space)}, tile {geo.t}, {storage}, {f0.dtype}): cudaError_t {rc}"
        )
    fetch_interior_halos.launches += 1
    return out


#: kernel launches since the last reset (set to 0 to reset)
fetch_interior_halos.launches = 0
