"""Burst-transfer plans: CFA vs the paper's three baselines, measured exactly.

Rather than *asserting* contiguity properties, this module enumerates the
exact set of linear addresses each scheme touches for a tile's flow-in reads
and flow-out writes, and counts maximal contiguous runs ("bursts").  This is
the measurement substrate behind the Fig. 15 reproduction:

* **CFA** (this paper): facet-allocated arrays; writes are full facet blocks
  (always one run each, by construction — verified, not assumed); reads are
  the needed flow-in addresses, host-assigned per the paper's rules, with a
  rectangular over-approximation mode mirroring §V-C1.
* **Original layout** (Bayliss et al. [16]): row-major canonical array,
  best-effort maximal runs, zero redundancy.
* **Bounding box** (Pouchet et al. [8]): row-major canonical array, one box
  around the flow-in (resp. flow-out), redundant transfer counted.
* **Data tiling** (Ozturk et al. [19]): block-major array; every touched data
  tile is moved in full, redundant transfer counted.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from .facets import FacetSpec, build_facet_specs, row_major_strides
from .irredundant import STORAGE_MODES, build_storage_map, owner_of
from .spaces import (
    Deps,
    IterSpace,
    Tiling,
    box_points,
    facet_widths,
    flow_in_points,
    flow_out_points,
    facet_points,
    tile_box,
)

__all__ = [
    "TransferPlan",
    "count_runs",
    "cfa_plan",
    "cfa_piece_census",
    "original_layout_plan",
    "bounding_box_plan",
    "data_tiling_plan",
    "interior_tile",
]


@dataclasses.dataclass(frozen=True)
class TransferPlan:
    """Aggregate burst statistics for one tile (reads + writes separable).

    ``read_run_hosts`` / ``write_run_hosts`` attribute each run to the facet
    array (by canonical axis) it is served from — the unit of contiguity a
    multi-port repartition moves around (``repro_torch.core.cfa.multiport``).  The
    CFA plans fill them; the single-array baselines leave them ``None``
    (their runs can still be repartitioned at burst granularity).

    Storage accounting (the footprint axis of the Ferry-2024 follow-up):
    ``storage`` names the discipline the plan was derived under;
    ``stored_elems`` is how many storage slots one tile's writes persist
    (counting duplicates under ``"redundant"``, exactly-once otherwise);
    ``footprint`` is the whole-layout stored-element total across the space;
    ``codec_bits`` is the fixed-ratio compression width (``None`` =
    uncompressed) that ``BurstModel`` turns into reduced bytes per burst.
    """

    scheme: str
    read_runs: tuple[int, ...]  # lengths (elements) of each read burst
    write_runs: tuple[int, ...]
    read_useful: int  # elements actually needed
    write_useful: int
    read_run_hosts: tuple[int, ...] | None = None  # facet axis per read run
    write_run_hosts: tuple[int, ...] | None = None  # facet axis per write run
    storage: str = "redundant"
    stored_elems: int | None = None  # slots one tile's writes persist
    footprint: int | None = None  # whole-layout stored elements
    codec_bits: int | None = None  # fixed-ratio compression width

    def __post_init__(self) -> None:
        if self.read_run_hosts is not None and len(self.read_run_hosts) != len(self.read_runs):
            raise ValueError("read_run_hosts must attribute every read run")
        if self.write_run_hosts is not None and len(self.write_run_hosts) != len(self.write_runs):
            raise ValueError("write_run_hosts must attribute every write run")
        if self.storage not in STORAGE_MODES:
            raise ValueError(
                f"storage must be one of {STORAGE_MODES}: {self.storage!r}"
            )
        # negative/zero guards mirroring the __post_init__ hardening of the space types:
        # a non-positive storage figure is always an accounting bug, never a
        # legal layout, so it must fail at construction rather than skew a
        # ranking downstream
        if self.stored_elems is not None and self.stored_elems <= 0:
            raise ValueError(
                f"stored_elems must be positive when set: {self.stored_elems}"
            )
        if self.footprint is not None and self.footprint <= 0:
            raise ValueError(
                f"footprint must be positive when set: {self.footprint}"
            )
        if self.codec_bits is not None and self.codec_bits <= 0:
            raise ValueError(
                f"codec_bits must be positive when set: {self.codec_bits}"
            )

    @property
    def n_read_bursts(self) -> int:
        return len(self.read_runs)

    @property
    def n_write_bursts(self) -> int:
        return len(self.write_runs)

    @property
    def n_bursts(self) -> int:
        return self.n_read_bursts + self.n_write_bursts

    @property
    def read_transferred(self) -> int:
        return int(sum(self.read_runs))

    @property
    def write_transferred(self) -> int:
        return int(sum(self.write_runs))

    @property
    def transferred(self) -> int:
        return self.read_transferred + self.write_transferred

    @property
    def useful(self) -> int:
        return self.read_useful + self.write_useful

    @property
    def redundancy(self) -> float:
        return 0.0 if not self.transferred else 1.0 - self.useful / self.transferred


def count_runs(addrs: np.ndarray) -> tuple[int, ...]:
    """Lengths of maximal runs of consecutive addresses (sorted, deduped)."""
    if addrs.size == 0:
        return ()
    a = np.unique(np.asarray(addrs, dtype=np.int64))
    breaks = np.flatnonzero(np.diff(a) != 1)
    starts = np.concatenate(([0], breaks + 1))
    ends = np.concatenate((breaks, [a.size - 1]))
    return tuple(int(e - s + 1) for s, e in zip(starts, ends))


def _boxed_runs(addrs: np.ndarray, gap: int) -> tuple[tuple[int, ...], int]:
    """Rectangular over-approximation (§V-C1): cluster the needed addresses,
    close gaps smaller than ``gap`` (one burst per cluster), and return
    (run lengths, transferred elements).  Redundancy = transferred - needed.
    """
    if addrs.size == 0:
        return (), 0
    a = np.unique(np.asarray(addrs, dtype=np.int64))
    breaks = np.flatnonzero(np.diff(a) > gap)
    starts = np.concatenate(([0], breaks + 1))
    ends = np.concatenate((breaks, [a.size - 1]))
    runs = tuple(int(a[e] - a[s] + 1) for s, e in zip(starts, ends))
    return runs, int(sum(runs))


def interior_tile(space: IterSpace, tiling: Tiling) -> tuple[int, ...]:
    """A representative interior tile (full flow-in/out on every side)."""
    nt = tiling.num_tiles(space)
    return tuple(min(1, n - 1) for n in nt)


# --------------------------------------------------------------------------
# CFA
# --------------------------------------------------------------------------


def _assign_hosts(
    pts: np.ndarray,
    tile: Sequence[int],
    tiling: Tiling,
    widths: Sequence[int],
    specs: Mapping[int, FacetSpec],
) -> dict[int, np.ndarray]:
    """Assign each flow-in point to the facet array it is read from.

    Implements the paper's choices, generalised to any dimension: single-axis
    pieces come from their own facet; a level-l piece (1 < l < d, crossing l
    axes) comes from a candidate facet whose extension direction is another
    crossed axis, so it merges with that host's lower-level run (§IV-H); the
    level-d corner comes from the facet minimising the number of leftover
    runs (§IV-I picks the facet whose extension axis has the thinnest width —
    for time-skewed stencils that is the time axis).  For d >= 4 some mid-
    level pieces have *no* candidate whose extension direction is crossed
    (§IV-J): they fall back to an arbitrary candidate and cost extra bursts,
    which the exact run counting below measures rather than hides
    (``cfa_piece_census`` reports the accounting).
    """
    d = tiling.ndim
    t = np.asarray(tiling.sizes, dtype=np.int64)
    q0 = np.asarray(tile, dtype=np.int64)
    qs = pts // t  # tile coords per point
    delta = qs - q0  # components in {0,-1} under the paper's hypotheses
    # candidate mask: point in facet_k domain AND crossing along k
    cand = np.zeros((len(pts), d), dtype=bool)
    for k, spec in specs.items():
        cand[:, k] = spec.domain_mask(pts) & (delta[:, k] < 0)
    out: dict[int, list[np.ndarray]] = {k: [] for k in specs}
    levels = (delta < 0).sum(axis=1)
    for lvl in np.unique(levels):
        sel = levels == lvl
        sub_cand = cand[sel]
        host = np.full(sel.sum(), -1, dtype=np.int64)
        sub_delta = delta[sel]
        if lvl == 1:
            host = np.argmax(sub_cand, axis=1)
        elif lvl < d:
            # prefer a host h whose extension direction is another crossed
            # axis: the piece then merges with h's lower-level facet read.
            for h in specs:
                c = specs[h].ext_dir
                ok = sub_cand[:, h] & (sub_delta[:, c] < 0) & (host < 0)
                host[ok] = h
            # fallback (non-mergeable piece, paper §IV-J): first candidate
            rem = host < 0
            host[rem] = np.argmax(sub_cand[rem], axis=1)
        else:
            # the level-d corner: host minimising leftover runs = thinnest ext
            order = sorted(specs, key=lambda h: (widths[specs[h].ext_dir], -h))
            for h in order:
                ok = sub_cand[:, h] & (host < 0)
                host[ok] = h
            rem = host < 0
            host[rem] = np.argmax(sub_cand[rem], axis=1)
        if not bool(sub_cand[np.arange(len(host)), host].all()):
            raise AssertionError(
                "flow-in point with no facet candidate — contradicts the "
                "appendix coverage proof; layout bug"
            )
        idx = np.flatnonzero(sel)
        for h in specs:
            out[h].append(idx[host == h])
    return {h: np.concatenate(v) if v else np.empty(0, dtype=np.int64) for h, v in out.items()}


def cfa_piece_census(
    space: IterSpace,
    deps: Deps,
    tiling: Tiling,
    tile: Sequence[int] | None = None,
    *,
    ext_dirs: Mapping[int, int] | None = None,
) -> dict:
    """§IV-D/H/J accounting of one tile's flow-in pieces, for the paper's
    final (intra-tile contiguity) layout family.

    A *piece* is the set of flow-in points sharing a backward neighbour tile
    (offset ``delta`` in {0,-1}^d, §IV-D) and an assigned host facet.
    Returns a dict with

    * ``pieces_by_level`` — piece count per neighbour level (number of
      crossed axes),
    * ``merged``          — pieces that extend an existing burst: level-1
      base reads, mid-level pieces whose host's extension direction is a
      crossed axis (§IV-H), and the level-d corner, whose crossed set
      contains every axis and which intra-tile contiguity makes a block
      suffix (§IV-I),
    * ``unmergeable``     — pieces with no such host.  Impossible for
      d <= 3 (the paper's construction reaches d+1 read bursts); generally
      unavoidable for d >= 4 (§IV-J) — each one starts an extra read burst,
      which ``cfa_plan``'s exact run counting measures.

    The merge model above describes the intra-tile layout only — weaker
    contiguity levels merge by address coincidence, not by construction, so
    their burst counts must be read off ``cfa_plan`` directly.
    """
    if tile is None:
        tile = interior_tile(space, tiling)
    widths = facet_widths(deps)
    specs = build_facet_specs(space, deps, tiling, ext_dirs=ext_dirs,
                              contiguity="intra-tile")
    fin = flow_in_points(space, deps, tiling, tile)
    hosts = _assign_hosts(fin, tile, tiling, widths, specs)
    d = tiling.ndim
    t = np.asarray(tiling.sizes, dtype=np.int64)
    q0 = np.asarray(tile, dtype=np.int64)
    by_level: dict[int, int] = {}
    merged = unmergeable = 0
    for k, idx in hosts.items():
        if idx.size == 0:
            continue
        delta = fin[idx] // t - q0
        for dlt in np.unique(delta, axis=0):
            lvl = int((dlt < 0).sum())
            by_level[lvl] = by_level.get(lvl, 0) + 1
            # the level-d corner crosses every axis, so ext_crossed also
            # covers it (§IV-I: the corner is a suffix of the host's block)
            ext_crossed = dlt[specs[k].ext_dir] < 0
            if lvl == 1 or ext_crossed:
                merged += 1
            else:
                unmergeable += 1
    return {
        "pieces_by_level": dict(sorted(by_level.items())),
        "merged": merged,
        "unmergeable": unmergeable,
    }


def _owner_hosts(
    pts: np.ndarray, specs: Mapping[int, FacetSpec]
) -> dict[int, np.ndarray]:
    """Irredundant read resolution: each point comes from the one facet that
    stores it (``irredundant.owner_of``) — no host choice exists."""
    own = owner_of(specs, pts)
    if (own < 0).any():
        raise AssertionError(
            "flow-in point outside every facet domain — contradicts the "
            "appendix coverage proof; layout bug"
        )
    return {k: np.flatnonzero(own == k) for k in specs}


def cfa_plan(
    space: IterSpace,
    deps: Deps,
    tiling: Tiling,
    tile: Sequence[int] | None = None,
    *,
    boxed: bool = True,
    ext_dirs: Mapping[int, int] | None = None,
    contiguity: str = "intra-tile",
    storage: str = "redundant",
    codec=None,
) -> TransferPlan:
    """CFA transfer plan for one tile.

    Writes: under ``storage="redundant"`` every facet block in full — one
    burst per facet by construction; under ``"irredundant"``/``"compressed"``
    only the owned slots (each value stored exactly once), whose runs the
    exact counting measures — deduplication trades write redundancy for
    extra write bursts, and the plan prices both sides honestly.
    Reads: flow-in points fetched from their host facets (redundant: the
    paper's §IV-H/I host assignment; irredundant: the owner facet — there
    is no choice); ``boxed`` applies the paper's rectangular
    over-approximation (merged bursts + guards), otherwise exact guarded
    runs are counted.  ``ext_dirs``/``contiguity`` select a layout variant
    (see ``build_facet_specs``); the defaults are the paper's final layout,
    which the autotuner treats as one candidate among the whole family.
    ``codec`` (``storage="compressed"`` only) sets ``codec_bits`` so
    ``BurstModel`` times the bursts at the fixed compression ratio.
    """
    if storage not in STORAGE_MODES:
        raise ValueError(f"storage must be one of {STORAGE_MODES}: {storage!r}")
    if codec is not None and storage != "compressed":
        raise ValueError(
            f'a codec only applies to storage="compressed", not {storage!r}'
        )
    if tile is None:
        tile = interior_tile(space, tiling)
    widths = facet_widths(deps)
    specs = build_facet_specs(space, deps, tiling, ext_dirs=ext_dirs, contiguity=contiguity)
    smap = build_storage_map(specs) if storage != "redundant" else None

    fin = flow_in_points(space, deps, tiling, tile)
    if storage == "redundant":
        hosts = _assign_hosts(fin, tile, tiling, widths, specs)
    else:
        hosts = _owner_hosts(fin, specs)
    read_runs: list[int] = []
    read_hosts: list[int] = []
    for k, idx in hosts.items():
        if idx.size == 0:
            continue
        addrs = specs[k].offsets(fin[idx])
        if boxed:
            runs, _ = _boxed_runs(addrs, gap=specs[k].block_elems)
        else:
            runs = count_runs(addrs)
        read_runs.extend(runs)
        read_hosts.extend([k] * len(runs))

    fout = flow_out_points(space, deps, tiling, tile)
    write_runs: list[int] = []
    write_hosts: list[int] = []
    for k, spec in specs.items():
        fpts = facet_points(tiling, widths, k, tile)
        if storage != "redundant":
            fpts = fpts[owner_of(specs, fpts) == k]
            if len(fpts) == 0:
                continue  # facet fully owned by lower axes (w_j == t_j)
            runs = count_runs(spec.offsets(fpts))
        else:
            runs = count_runs(spec.offsets(fpts))
            assert len(runs) == 1, "full-tile contiguity violated — layout bug"
        write_runs.extend(runs)
        write_hosts.extend([k] * len(runs))

    if storage == "redundant":
        stored = sum(s.block_elems for s in specs.values())
        footprint = sum(s.size for s in specs.values())
        codec_bits = None
    else:
        stored = sum(smap.owned_per_block.values())
        footprint = smap.stored_elems
        codec_bits = None
        if storage == "compressed":
            from .compress import get_codec

            bits = get_codec(codec).bits
            codec_bits = bits if bits else None  # "raw" models as uncompressed
    return TransferPlan(
        scheme="cfa" if boxed else "cfa-exact",
        read_runs=tuple(read_runs),
        write_runs=tuple(write_runs),
        read_useful=int(len(fin)),
        write_useful=int(len(fout)),
        read_run_hosts=tuple(read_hosts),
        write_run_hosts=tuple(write_hosts),
        storage=storage,
        stored_elems=int(stored),
        footprint=int(footprint),
        codec_bits=codec_bits,
    )


# --------------------------------------------------------------------------
# Baselines (row-major canonical / block-major layouts)
# --------------------------------------------------------------------------


def _row_major_offsets(pts: np.ndarray, sizes: Sequence[int]) -> np.ndarray:
    return np.atleast_2d(pts) @ row_major_strides(sizes)


def original_layout_plan(
    space: IterSpace, deps: Deps, tiling: Tiling, tile: Sequence[int] | None = None
) -> TransferPlan:
    """Best-effort bursts under the untouched row-major layout (Bayliss [16])."""
    if tile is None:
        tile = interior_tile(space, tiling)
    fin = flow_in_points(space, deps, tiling, tile)
    fout = flow_out_points(space, deps, tiling, tile)
    rr = count_runs(_row_major_offsets(fin, space.sizes))
    wr = count_runs(_row_major_offsets(fout, space.sizes))
    return TransferPlan("original", rr, wr, int(len(fin)), int(len(fout)),
                        footprint=int(np.prod(space.sizes, dtype=np.int64)))


def bounding_box_plan(
    space: IterSpace, deps: Deps, tiling: Tiling, tile: Sequence[int] | None = None
) -> TransferPlan:
    """Rectangular bounding box of flow-in / flow-out (Pouchet et al. [8])."""
    if tile is None:
        tile = interior_tile(space, tiling)

    def _box_runs(pts: np.ndarray) -> tuple[int, ...]:
        if pts.size == 0:
            return ()
        lo, hi = pts.min(axis=0), pts.max(axis=0) + 1
        return count_runs(_row_major_offsets(box_points(lo, hi), space.sizes))

    fin = flow_in_points(space, deps, tiling, tile)
    fout = flow_out_points(space, deps, tiling, tile)
    return TransferPlan("bbox", _box_runs(fin), _box_runs(fout),
                        int(len(fin)), int(len(fout)),
                        footprint=int(np.prod(space.sizes, dtype=np.int64)))


def data_tiling_plan(
    space: IterSpace,
    deps: Deps,
    tiling: Tiling,
    tile: Sequence[int] | None = None,
    *,
    block: Sequence[int] | None = None,
) -> TransferPlan:
    """Block-major data tiling; touched blocks moved whole (Ozturk et al. [19]).

    ``block`` defaults to the iteration tile sizes (the paper reports the best
    performing block <= iteration tile size; callers sweep candidates).
    """
    if tile is None:
        tile = interior_tile(space, tiling)
    blk = np.asarray(block if block is not None else tiling.sizes, dtype=np.int64)
    nb = tuple(-(-n // b) for n, b in zip(space.sizes, blk))
    layout_sizes = tuple(nb) + tuple(int(b) for b in blk)

    def _block_runs(pts: np.ndarray) -> tuple[int, ...]:
        if pts.size == 0:
            return ()
        blocks = np.unique(pts // blk, axis=0)
        all_pts = []
        for qb in blocks:
            lo = qb * blk
            hi = np.minimum(lo + blk, space.sizes)
            bpts = box_points(lo, hi)
            idx = np.concatenate([qb[None, :].repeat(len(bpts), 0), bpts % blk], axis=1)
            all_pts.append(idx)
        return count_runs(_row_major_offsets(np.concatenate(all_pts), layout_sizes))

    fin = flow_in_points(space, deps, tiling, tile)
    fout = flow_out_points(space, deps, tiling, tile)
    return TransferPlan(
        f"data-tiling{tuple(int(b) for b in blk)}",
        _block_runs(fin),
        _block_runs(fout),
        int(len(fin)),
        int(len(fout)),
        footprint=int(np.prod(layout_sizes, dtype=np.int64)),
    )
