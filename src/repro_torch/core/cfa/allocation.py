"""Canonical <-> facet storage conversion in PyTorch.

``pack_facet`` materialises the CFA facet arrays from a canonical (row-major)
value volume; ``unpack_into`` scatters facet contents back.  Both are
compositions of reshape / static index_select / permute only.  They exist
for round-trip validation, for importing live-in data, and for exporting
results — the execution pipeline itself (transform.py) writes facet blocks
directly and never materialises the canonical volume.

Both directions understand the irredundant storage discipline
(``repro_torch.core.cfa.irredundant``): ``pack_all(..., storage_map=...)``
zeroes the non-owned slots it would otherwise duplicate into, and
``unpack_into(..., owned=...)`` scatters only owned slots — so a
deduplicated payload round-trips without the dead zeros clobbering values
another facet owns.  Every function returns new tensors on the input's
device and leaves its arguments unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from .facets import FacetSpec

__all__ = ["pack_facet", "pack_all", "unpack_into"]


def _check_packable(spec: FacetSpec) -> None:
    """The pack/unpack legality gate: w | t_k, so the modulo labelling is
    tile-independent.  Raised up front by every public entry point, so
    callers never pay partial reshape work — or trip an unrelated reshape
    error — before the documented ``ValueError``."""
    t_k, w = spec.tile_sizes[spec.axis], spec.width
    if t_k % w:
        raise ValueError(
            f"pack/unpack require w | t on axis {spec.axis} (t={t_k}, w={w}); "
            "use the sweep executor for tile-dependent modulo labelling"
        )


def _modulo_perm(spec: FacetSpec) -> np.ndarray:
    """Map slab position j (0..w-1, i.e. x_k = t_k - w + j within the tile) to
    the paper's modulo coordinate m = x_k mod w.  Requires w | t_k so the
    labelling is tile-independent."""
    _check_packable(spec)
    t_k, w = spec.tile_sizes[spec.axis], spec.width
    return np.array([(t_k - w + j) % w for j in range(w)], dtype=np.int64)


def _interleaved(spec: FacetSpec, volume_shape) -> list[int]:
    shape = []
    for a in range(spec.ndim):
        nt = volume_shape[a] // spec.tile_sizes[a]
        shape += [nt, spec.tile_sizes[a]]
    return shape


def _take_last(W: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return W.index_select(-1, torch.from_numpy(idx).to(W.device))


def pack_facet(volume: torch.Tensor, spec: FacetSpec) -> torch.Tensor:
    """Extract facet array ``spec`` from a canonical value volume."""
    _check_packable(spec)
    t_k, w, k = spec.tile_sizes[spec.axis], spec.width, spec.axis
    W = volume.reshape(_interleaved(spec, volume.shape))  # (q0, r0, q1, r1, ...)
    rdim = 2 * k + 1
    # tail slab along axis k, then relabel to the modulo coordinate
    W = torch.movedim(W, rdim, -1)[..., t_k - w:]
    inv = np.argsort(_modulo_perm(spec))  # modulo index m -> slab position j
    W = torch.movedim(_take_last(W, inv), -1, rdim)
    order = [2 * a for a in spec.outer_axes] + [2 * a + 1 for a in spec.inner_axes]
    return W.permute(order).contiguous()


def pack_all(volume: torch.Tensor, specs: dict[int, FacetSpec],
             storage_map=None) -> dict[int, torch.Tensor]:
    """Pack every facet; with an irredundant ``storage_map``
    (:class:`repro_torch.core.cfa.irredundant.StorageMap`), non-owned slots
    are zeroed — the exact payload an irredundant execution commits.

    Validates w | t for *all* facets up front, so a mixed family fails with
    the documented ``ValueError`` before any tensor is materialised.
    """
    for s in specs.values():
        _check_packable(s)
    packed = {k: pack_facet(volume, s) for k, s in specs.items()}
    if storage_map is None:
        return packed
    from .irredundant import dedup_facets

    return dedup_facets(packed, storage_map)


def unpack_into(volume: torch.Tensor, facet: torch.Tensor, spec: FacetSpec,
                owned: np.ndarray | None = None) -> torch.Tensor:
    """Scatter a facet array's contents back into (a copy of) a canonical
    volume.

    ``owned`` (the facet's mask from an irredundant
    :class:`~repro_torch.core.cfa.irredundant.StorageMap`, in block/inner-dims
    order) restricts the scatter to owned slots, so a deduplicated facet's
    dead zeros never clobber canonical points another facet owns.
    """
    _check_packable(spec)
    d = spec.ndim
    t_k, w, k = spec.tile_sizes[spec.axis], spec.width, spec.axis
    order = [2 * a for a in spec.outer_axes] + [2 * a + 1 for a in spec.inner_axes]
    inv_order = np.argsort(order).tolist()
    W = facet.permute(inv_order)  # back to (q0, r0(, modulo on k), ...)
    rdim = 2 * k + 1
    perm = _modulo_perm(spec)  # slab position j -> modulo index m
    W = torch.movedim(_take_last(torch.movedim(W, rdim, -1), perm), -1, rdim)
    V = volume.reshape(_interleaved(spec, volume.shape)).clone()
    idx = [slice(None)] * (2 * d)
    idx[rdim] = slice(t_k - w, t_k)
    if owned is not None:
        # the mask lives in block (inner-dims) order and is constant along
        # the modulo axis; route it through the same permute/movedim as the
        # data, then let the interleaved (q, r) dims broadcast over it
        M = np.broadcast_to(np.asarray(owned, bool), tuple(facet.shape))
        M = M.transpose(inv_order)
        M = np.moveaxis(np.moveaxis(M, rdim, -1)[..., perm], -1, rdim)
        W = torch.where(torch.from_numpy(np.ascontiguousarray(M)).to(V.device),
                        W, V[tuple(idx)])
    V[tuple(idx)] = W
    return V.reshape(volume.shape)
