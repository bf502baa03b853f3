"""Irredundant facet storage: every canonical value stored exactly once.

The paper's facet layout buys burst contiguity by *duplicating* halo data:
a point in the tail slab of several axes lies in several facets' projection
domains and is stored — and written — once per facet (``TransferPlan``
measures the tax as ``redundancy``).  The authors' follow-up (Ferry et al.,
2024, *An Irredundant and Compressed Data Layout...*) removes the duplicates
by giving every point exactly one **owner** facet; this module is that
storage discipline:

* :func:`owner_of` — the deterministic ownership rule: a point in several
  facet domains is owned by the **lowest** facet axis (the time facet wins
  corners, matching the paper's host preference for the thinnest/first axis).
  Ownership depends only on intra-tile coordinates, so it is a static,
  tile-independent mask over each facet block.
* :class:`StorageMap` / :func:`build_storage_map` — the per-facet owned
  masks plus the footprint accounting: ``stored_elems`` (each value once),
  ``redundant_elems`` (the paper's layout), ``redundancy`` (stored /
  distinct — 1.0 by construction), ``savings``.
* :func:`dedup_facets` / :func:`rehydrate_facets` — drop non-owned slots
  (they read as zeros) / refill them from their owner facets, so an
  irredundant execution payload compares bit-for-bit against the redundant
  one.  Both run on the facets' device.
* :class:`IrredundantPipeline` — a ``CFAPipeline`` whose ``copy_out``
  commits only owned slots and whose ``copy_in`` resolves every halo read
  to the owner facet's storage (the owner-facet indirection; the CUDA read
  engine ``repro_torch.kernels.facet_fetch`` mirrors it).
* :class:`CompressedPipeline` — additionally passes every committed block
  through a fixed-ratio :class:`~repro_torch.core.cfa.compress.BlockCodec`
  round-trip, so results reflect exactly what compressed storage preserved.

As in the port's ``CFAPipeline``, commits are in place: the masked commit
writes the owned slots of the facet tensor and leaves the dead slots
untouched.  The burst-accounting counterpart (owner-resolved reads,
owned-run writes, ``footprint``/``stored_elems`` on the plan) lives in
``repro_torch.core.cfa.plans.cfa_plan(storage="irredundant")``.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Mapping

import numpy as np
import torch

from .compress import BlockCodec, get_codec
from .facets import FacetSpec, row_major_strides
from .transform import CFAPipeline

__all__ = [
    "STORAGE_MODES",
    "owner_of",
    "StorageMap",
    "build_storage_map",
    "dedup_facets",
    "rehydrate_facets",
    "IrredundantPipeline",
    "CompressedPipeline",
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


def dedup_facets(
    facets: dict[int, torch.Tensor], smap: StorageMap
) -> dict[int, torch.Tensor]:
    """Zero the non-owned slots (what irredundant storage never writes)."""
    out = {}
    for k, arr in facets.items():
        mask = smap.owned[k]
        if mask.all():
            out[k] = arr
        else:  # masks cover the inner dims; outer (tile) dims broadcast
            m = torch.from_numpy(mask).to(arr.device)
            out[k] = torch.where(m, arr, torch.zeros((), dtype=arr.dtype,
                                                     device=arr.device))
    return out


def _virtual_shift(spec: FacetSpec, arr: torch.Tensor) -> int:
    """Flat-offset shift when ``arr`` carries extra leading block rows
    beyond ``spec.shape`` (facet_0's virtual live-in row)."""
    extra = arr.shape[0] - spec.shape[0]
    return extra * int(np.prod(spec.shape[1:], dtype=np.int64))


def _offsets(spec: FacetSpec, x: torch.Tensor) -> torch.Tensor:
    """``FacetSpec.offsets`` on an int64 tensor of in-domain points."""
    t = spec.tile_sizes
    strides = row_major_strides(spec.shape).tolist()
    cols = [x[:, a] // t[a] for a in spec.outer_axes]
    cols += [x[:, a] % (spec.width if a == spec.axis else t[a])
             for a in spec.inner_axes]
    off = torch.zeros_like(cols[0])
    for c, s in zip(cols, strides):
        off += c * s
    return off


def rehydrate_facets(
    facets: dict[int, torch.Tensor], smap: StorageMap
) -> dict[int, torch.Tensor]:
    """Refill every non-owned slot from its owner facet's storage.

    The inverse of :func:`dedup_facets` given owner values: applied to an
    irredundant execution payload it reconstructs the redundant payload
    bit-for-bit (duplicated slots duplicate the owner's value by
    construction — both were committed from the same tile interior).
    Facet_0's virtual live-in row passes through untouched: facet_0 is
    fully owned (lowest axis), and dead slots of other facets decode to
    in-space points, whose owner storage is a real (shifted) facet_0 row.

    The dead slots of one block are static numpy; they are broadcast over
    every tile block, decoded to canonical points, resolved to their owner
    facets and gathered/scattered on the facets' device (the reference's
    ``np.argwhere`` over whole facet arrays does not scale to full-size
    payloads).  Returns new tensors; ``facets`` is not modified.
    """
    specs = smap.specs
    out = dict(facets)
    for k, spec in specs.items():
        mask = smap.owned[k]
        if mask.all():
            continue
        arr = facets[k]
        dev = arr.device
        n_outer = len(spec.outer_axes)
        outer_shape = tuple(arr.shape[:n_outer])
        t = spec.tile_sizes
        # every block's outer (tile) multi-index, and one block's dead slots
        grids = torch.meshgrid(*(torch.arange(n, device=dev) for n in outer_shape),
                               indexing="ij")
        outer = torch.stack([g.reshape(-1) for g in grids], dim=1)  # (T, n_outer)
        dead_np = np.argwhere(~mask)  # (m, n_inner)
        dead = torch.from_numpy(dead_np).to(dev)
        q = {a: outer[:, col, None] for col, a in enumerate(spec.outer_axes)}
        x = torch.empty((outer.shape[0], dead.shape[0], spec.ndim),
                        dtype=torch.int64, device=dev)
        for col, a in enumerate(spec.inner_axes):
            c = dead[None, :, col]
            if a == spec.axis:  # modulo label -> slab position (per tile)
                w = spec.width
                base = q[a] * t[a] + t[a] - w
                x[..., a] = base + (c - base) % w
            else:
                x[..., a] = q[a] * t[a] + c
        x = x.reshape(-1, spec.ndim)
        own = torch.full((x.shape[0],), -1, dtype=torch.int64, device=dev)
        for j in sorted(specs):  # ascending axis == ownership priority
            tj, wj = specs[j].tile_sizes[j], specs[j].width
            own[(own < 0) & ((x[:, j] % tj) >= tj - wj)] = j
        if bool(((own < 0) | (own >= k)).any()):
            raise AssertionError(
                "dead slot without a lower-axis owner — storage-map bug"
            )
        vals = torch.empty(x.shape[0], dtype=arr.dtype, device=dev)
        for j in torch.unique(own).tolist():
            sel = own == j
            offs = _offsets(specs[j], x[sel]) + _virtual_shift(specs[j], facets[j])
            vals[sel] = facets[j].reshape(-1)[offs]
        block = spec.block_elems
        # integer matmuls do not run on CUDA: the static half in numpy, the
        # per-block half as a multiply-sum on the device
        inner_flat = torch.from_numpy(dead_np @ row_major_strides(mask.shape)).to(dev)
        outer_flat = (outer * torch.from_numpy(row_major_strides(outer_shape)).to(dev)).sum(1)
        flat_idx = (outer_flat[:, None] * block + inner_flat[None, :]).reshape(-1)
        flat = arr.reshape(-1).clone()
        flat[flat_idx] = vals
        out[k] = flat.reshape(arr.shape)
    return out


# --------------------------------------------------------------------------
# Execution pipelines
# --------------------------------------------------------------------------


@dataclasses.dataclass
class IrredundantPipeline(CFAPipeline):
    """``CFAPipeline`` under the irredundant storage discipline.

    Same facet shapes, same schedule, two overrides:

    * ``copy_out`` (via ``_commit_block``) commits only owned slots — a
      value is written exactly once, to its owner facet; the dead slots of
      the facet tensor are left untouched;
    * ``copy_in`` (via ``_halo_hosts``) reads every halo point from its
      owner facet, whether or not that facet's axis is crossed — the
      owner-facet indirection (non-owned slots hold nothing).

    The payload therefore has zeros in every non-owned slot; pass it
    through :func:`rehydrate_facets` to compare against a redundant run.
    """

    storage: ClassVar[str] = "irredundant"
    storage_map: StorageMap = dataclasses.field(init=False, repr=False, compare=False)
    # the owned masks of the partially owned facets, on the pipeline's device
    _owned: dict = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self) -> None:
        super().__post_init__()
        self.storage_map = build_storage_map(self.specs)
        self._owned = {k: torch.from_numpy(m).to(self.device)
                       for k, m in self.storage_map.owned.items() if not m.all()}

    def _halo_hosts(self, pts, lo, taken):
        """Owner-priority halo sourcing: ascending facet axis, domain
        membership only (the crossing direction is irrelevant to where a
        value is *stored*)."""
        maps = {}
        for k, spec in self.specs.items():
            mask = ~taken & spec.domain_mask(pts)
            if mask.any():
                maps[k] = pts[mask]
                taken |= mask
        return maps

    def _commit_block(self, arr, idx, block, spec):
        mask = self._owned.get(spec.axis)
        if mask is None:
            return super()._commit_block(arr, idx, block, spec)
        # owned slots get the new value; non-owned slots stay untouched
        dst = arr[idx]
        dst.copy_(torch.where(mask, block, dst))
        return arr


@dataclasses.dataclass
class CompressedPipeline(IrredundantPipeline):
    """Irredundant storage + fixed-ratio block compression (Ferry 2024).

    Every committed block is passed through the codec's encode/decode
    round-trip before storage, so the facets hold exactly what compressed
    memory would return — bit-identical to the irredundant pipeline when
    the codec is exact on the data (e.g. the ``raw`` codec, or bit-truncated
    inputs under ``deltapack16``), measurably quantised otherwise.  The
    bytes-per-burst effect is modeled by ``BurstModel`` via
    ``TransferPlan.codec_bits``, not re-simulated here.
    """

    storage: ClassVar[str] = "compressed"
    codec: BlockCodec | str | None = None

    def __post_init__(self) -> None:
        super().__post_init__()
        self.codec = get_codec(self.codec)

    def _commit_block(self, arr, idx, block, spec):
        # storage holds the block layout, so the codec sees it as written
        return super()._commit_block(arr, idx, self.codec.roundtrip(block),
                                     spec)
