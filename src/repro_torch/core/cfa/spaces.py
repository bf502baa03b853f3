"""Polyhedral-lite integer machinery for Canonical Facet Allocation (CFA).

The paper (Ferry et al., "Increasing FPGA Accelerators Memory Bandwidth with
a Burst-Friendly Memory Layout", 2022) restricts itself to

  * rectangular iteration spaces,
  * rectangular tiles,
  * uniform dependencies whose vectors are backwards in every dimension
    (any skewing required to reach this normal form is assumed to have been
    applied beforehand, §IV-E).

Under those hypotheses full ISL generality is unnecessary: every set we
manipulate is a union of integer boxes.  This module provides exactly that —
boxes, uniform dependence patterns, tiles, and the flow-in / flow-out /
facet point sets of the paper, materialised as ``numpy`` integer point
arrays so that downstream analyses (burst-run counting, coverage proofs,
property tests) are exact rather than asserted.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Sequence

import numpy as np

__all__ = [
    "IterSpace",
    "Deps",
    "Tiling",
    "facet_widths",
    "box_points",
    "tile_box",
    "tile_points",
    "flow_in_points",
    "flow_out_points",
    "facet_points",
    "neighbor_offsets",
]


@dataclasses.dataclass(frozen=True)
class IterSpace:
    """Rectangular iteration space ``E = [0,N_1) x ... x [0,N_d)``."""

    sizes: tuple[int, ...]

    def __post_init__(self) -> None:
        if not self.sizes or any(n <= 0 for n in self.sizes):
            raise ValueError(f"iteration space sizes must be positive: {self.sizes}")

    @property
    def ndim(self) -> int:
        return len(self.sizes)

    def contains(self, pts: np.ndarray) -> np.ndarray:
        """Boolean mask of which points (n, d) lie inside the space."""
        pts = np.atleast_2d(pts)
        lo = (pts >= 0).all(axis=1)
        hi = (pts < np.asarray(self.sizes)).all(axis=1)
        return lo & hi


@dataclasses.dataclass(frozen=True)
class Deps:
    """Uniform dependence pattern: iteration ``x`` reads ``x + B_q``.

    All components of every vector must be <= 0 ("backwards in all
    dimensions"), which is the paper's legality condition for rectangular
    tiling (§IV-D/E).
    """

    vectors: tuple[tuple[int, ...], ...]

    def __post_init__(self) -> None:
        if not self.vectors:
            raise ValueError("dependence pattern must be non-empty")
        d = len(self.vectors[0])
        for v in self.vectors:
            if len(v) != d:
                raise ValueError(f"inconsistent dependence arity: {self.vectors}")
            if any(c > 0 for c in v):
                raise ValueError(
                    f"dependence vector {v} is not backwards in all dimensions; "
                    "skew the iteration space first (paper §IV-E)"
                )
        if all(all(c == 0 for c in v) for v in self.vectors):
            raise ValueError("all-zero dependence pattern")

    @property
    def ndim(self) -> int:
        return len(self.vectors[0])

    def as_array(self) -> np.ndarray:
        return np.asarray(self.vectors, dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class Tiling:
    """Rectangular tile sizes ``t_1 .. t_d``.

    The framework requires ``N_k % t_k == 0``; callers pad the space when the
    problem size is not a multiple (mirroring the full-tile codegen of the
    paper's proof-of-concept pass).
    """

    sizes: tuple[int, ...]

    def __post_init__(self) -> None:
        if any(t <= 0 for t in self.sizes):
            raise ValueError(f"tile sizes must be positive: {self.sizes}")

    @property
    def ndim(self) -> int:
        return len(self.sizes)

    def num_tiles(self, space: IterSpace) -> tuple[int, ...]:
        if space.ndim != self.ndim:
            raise ValueError(
                f"tiling {self.sizes} is {self.ndim}-D but the space "
                f"{space.sizes} is {space.ndim}-D"
            )
        for n, t in zip(space.sizes, self.sizes, strict=True):
            if n % t:
                raise ValueError(
                    f"space {space.sizes} not divisible by tiles {self.sizes}; pad first"
                )
        return tuple(n // t for n, t in zip(space.sizes, self.sizes, strict=True))


def facet_widths(deps: Deps) -> tuple[int, ...]:
    """``w_k = max_q |e_k . B_q|`` — facet thickness per canonical axis (§IV-F3).

    ``w_k == 0`` means no dependence crosses faces normal to axis ``k`` and no
    facet array is allocated for that axis.
    """
    b = deps.as_array()
    return tuple(int(w) for w in np.abs(b).max(axis=0))


def box_points(lo: Sequence[int], hi: Sequence[int]) -> np.ndarray:
    """All integer points of the half-open box ``[lo, hi)`` as an (n, d) array."""
    axes = [np.arange(l, h, dtype=np.int64) for l, h in zip(lo, hi)]
    if any(a.size == 0 for a in axes):
        return np.empty((0, len(axes)), dtype=np.int64)
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=1)


def tile_box(tile: Sequence[int], tiling: Tiling) -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi) corners of the tile with coordinates ``tile``."""
    t = np.asarray(tiling.sizes, dtype=np.int64)
    q = np.asarray(tile, dtype=np.int64)
    return q * t, (q + 1) * t


def tile_points(tile: Sequence[int], tiling: Tiling) -> np.ndarray:
    lo, hi = tile_box(tile, tiling)
    return box_points(lo, hi)


def _unique_rows(pts: np.ndarray) -> np.ndarray:
    if pts.size == 0:
        return pts
    return np.unique(pts, axis=0)


def flow_in_points(
    space: IterSpace, deps: Deps, tiling: Tiling, tile: Sequence[int]
) -> np.ndarray:
    """The iteration-wise flow-in set of a tile (paper appendix):

        phi_i(T) = { y in E \\ T : exists q, y - B_q in T }
                 = union_q (T + B_q) intersect E, minus T.
    """
    lo, hi = tile_box(tile, tiling)
    pieces = []
    for b in deps.as_array():
        pts = box_points(lo + b, hi + b)
        pts = pts[space.contains(pts)]
        pieces.append(pts)
    pts = _unique_rows(np.concatenate(pieces, axis=0)) if pieces else np.empty((0, space.ndim))
    inside = ((pts >= lo) & (pts < hi)).all(axis=1)
    return pts[~inside]


def flow_out_points(
    space: IterSpace, deps: Deps, tiling: Tiling, tile: Sequence[int]
) -> np.ndarray:
    """Iterations of T whose results are consumed by another tile:

        phi_o(T) = { x in T : exists q, x - B_q in E \\ T }.
    """
    pts = tile_points(tile, tiling)
    lo, hi = tile_box(tile, tiling)
    used = np.zeros(len(pts), dtype=bool)
    for b in deps.as_array():
        cons = pts - b  # consumer iteration y = x - B (y + B = x)
        in_space = space.contains(cons)
        in_tile = ((cons >= lo) & (cons < hi)).all(axis=1)
        used |= in_space & ~in_tile
    return pts[used]


def facet_points(
    tiling: Tiling, widths: Sequence[int], axis: int, tile: Sequence[int]
) -> np.ndarray:
    """The k-th facet of tile T (paper appendix):

        S_k(T) = { x in T : t_k - w_k <= x_k mod t_k }.
    """
    w = widths[axis]
    if w <= 0:
        return np.empty((0, tiling.ndim), dtype=np.int64)
    lo, hi = tile_box(tile, tiling)
    lo = lo.copy()
    lo[axis] = hi[axis] - w
    return box_points(lo, hi)


def neighbor_offsets(d: int, *, max_level: int | None = None) -> list[tuple[int, ...]]:
    """All backward neighbor tile offsets delta in {0,-1}^d \\ {0}.

    The number of nonzero components is the neighbor "level" of §IV-D.
    """
    out = []
    for delta in itertools.product((0, -1), repeat=d):
        lvl = sum(1 for c in delta if c)
        if lvl == 0:
            continue
        if max_level is not None and lvl > max_level:
            continue
        out.append(delta)
    return out
