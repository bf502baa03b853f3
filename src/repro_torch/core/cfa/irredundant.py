"""Irredundant facet storage: the ownership rule and its footprint map.

The paper's facet layout buys burst contiguity by *duplicating* halo data:
a point in the tail slab of several axes lies in several facets' projection
domains and is stored — and written — once per facet (``TransferPlan``
measures the tax as ``redundancy``).  The authors' follow-up (Ferry et al.,
2024, *An Irredundant and Compressed Data Layout...*) removes the duplicates
by giving every point exactly one **owner** facet.  This module holds the
static part of that discipline, which the burst plans price:

* :func:`owner_of` — the deterministic ownership rule: a point in several
  facet domains is owned by the **lowest** facet axis (the time facet wins
  corners, matching the paper's host preference for the thinnest/first axis).
  Ownership depends only on intra-tile coordinates, so it is a static,
  tile-independent mask over each facet block.
* :class:`StorageMap` / :func:`build_storage_map` — the per-facet owned
  masks plus the footprint accounting: ``stored_elems`` (each value once),
  ``redundant_elems`` (the paper's layout), ``redundancy`` (stored /
  distinct — 1.0 by construction), ``savings``.

The executing side (``dedup_facets``/``rehydrate_facets`` and the
irredundant/compressed pipelines) arrives with the port's storage slice.
The burst-accounting counterpart (owner-resolved reads, owned-run writes,
``footprint``/``stored_elems`` on the plan) lives in
``repro_torch.core.cfa.plans.cfa_plan(storage="irredundant")``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from .facets import FacetSpec

__all__ = [
    "STORAGE_MODES",
    "owner_of",
    "StorageMap",
    "build_storage_map",
]

#: The three facet storage disciplines ``cfa.compile`` exposes: the paper's
#: duplicated layout, the deduplicated one, and deduplicated + fixed-ratio
#: block compression (Ferry 2024).
STORAGE_MODES = ("redundant", "irredundant", "compressed")


def owner_of(specs: Mapping[int, FacetSpec], pts: np.ndarray) -> np.ndarray:
    """Owner facet axis per point: the lowest axis whose projection domain
    contains the point; ``-1`` for points in no facet domain."""
    pts = np.atleast_2d(np.asarray(pts, dtype=np.int64))
    owner = np.full(len(pts), -1, dtype=np.int64)
    for k in sorted(specs):  # ascending axis == ownership priority
        m = (owner < 0) & specs[k].domain_mask(pts)
        owner[m] = k
    return owner


@dataclasses.dataclass(frozen=True)
class StorageMap:
    """The irredundant storage discipline for one facet family.

    ``owned[k]`` is a boolean mask over facet ``k``'s *block* (inner dims,
    in ``inner_axes`` order): True where the slot's canonical point is owned
    by facet ``k``.  Ownership never depends on the axis-``k`` (modulo)
    coordinate, so the masks are exact for tile-dependent modulo labelling
    too, and identical for every tile block.
    """

    specs: dict[int, FacetSpec]
    owned: dict[int, np.ndarray]

    @property
    def owned_per_block(self) -> dict[int, int]:
        """Owned slots in one tile's block, per facet."""
        return {k: int(m.sum()) for k, m in self.owned.items()}

    def stores(self, k: int, pts: np.ndarray) -> np.ndarray:
        """Boolean per point: does facet ``k`` *store* it — i.e. the point
        lies in facet ``k``'s projection domain *and* lands on an owned
        slot?  Summed over facets this counts a point's storage slots; the
        static verifier (``analysis.check_facet_family``) proves the count
        is exactly one over the whole family."""
        spec = self.specs[k]
        pts = np.atleast_2d(np.asarray(pts, dtype=np.int64))
        out = np.zeros(len(pts), dtype=bool)
        dom = spec.domain_mask(pts)
        if dom.any():
            inner = spec.coords(pts[dom])[:, len(spec.outer_axes):]
            out[np.flatnonzero(dom)] = self.owned[k][tuple(inner.T)]
        return out

    @property
    def stored_elems(self) -> int:
        """Total slots the irredundant layout stores (each value once)."""
        return sum(
            int(self.owned[k].sum()) * (s.size // s.block_elems)
            for k, s in self.specs.items()
        )

    @property
    def redundant_elems(self) -> int:
        """Total slots the paper's duplicated layout stores."""
        return sum(s.size for s in self.specs.values())

    @property
    def redundancy(self) -> float:
        """Stored slots per distinct value — 1.0: single assignment.

        The ownership rule partitions every tile's facet union, so this is
        1.0 *by construction*; the property tests verify the partition on
        random spaces rather than trusting the closed form.
        """
        return 1.0 if self.stored_elems else 0.0

    @property
    def savings(self) -> float:
        """Fraction of the redundant layout's slots the dedup removes."""
        red = self.redundant_elems
        return 0.0 if not red else 1.0 - self.stored_elems / red


def build_storage_map(specs: Mapping[int, FacetSpec]) -> StorageMap:
    """Derive the owned masks for a facet family.

    A slot of facet ``k``'s block with intra-tile coordinate ``r`` is owned
    iff no lower-axis facet ``j < k`` also covers it, i.e. iff
    ``r_j < t_j - w_j`` for every facet axis ``j < k`` — the complement of
    facet ``j``'s tail slab.  (Facet ``k`` covers its own block by
    definition, and the axis-``k`` inner coordinate is the modulo label,
    which ownership never consults.)
    """
    owned: dict[int, np.ndarray] = {}
    for k, spec in specs.items():
        mask = np.ones(
            tuple(spec.inner_size(a) for a in spec.inner_axes), dtype=bool
        )
        for pos, a in enumerate(spec.inner_axes):
            if a < k and a in specs:
                t_a, w_a = spec.tile_sizes[a], specs[a].width
                sl = [slice(None)] * mask.ndim
                sl[pos] = slice(t_a - w_a, t_a)
                mask[tuple(sl)] = False
        owned[k] = mask
    return StorageMap(specs=dict(specs), owned=owned)
