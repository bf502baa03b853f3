"""Facet array specifications: multi-projection, single-assignment, and the
dimension permutations that give CFA its three contiguity levels (§IV.F-I).

For each canonical axis ``k`` with facet width ``w_k > 0`` we allocate one
*facet array*.  Its index space is

    [ outer (tile-coordinate) dims, permuted ] x [ inner (intra-tile) dims, permuted ]

with the following paper-faithful layout rules:

* **single-assignment** (§IV-F4): the tile coordinate along ``k`` itself is an
  outer dimension, so no two tiles share storage; it is placed *first* among
  the outer dims.
* **full-tile contiguity** (§IV-G): the inner dims form one contiguous block
  per tile (data tiling with the iteration tile sizes), so each facet write is
  a single burst.
* **inter-tile contiguity** (§IV-H): every facet gets an *extension direction*
  ``c_k`` (a projected axis).  The tile coordinate of ``c_k`` is the last
  outer dim and ``c_k`` itself is the first inner dim, so a read that spans
  the facet of tile ``q`` and the trailing slab of tile ``q - e_{c_k}`` is one
  contiguous run ("facet extensions", Fig. 8).
* **intra-tile contiguity** (§IV-I): the modulo dimension ``x_k mod w_k`` is
  the last inner dim, so corner sets from 3rd-level neighbours are contiguous
  suffixes of a facet block.

By default we assign extension directions cyclically, ``c_k = (k+1) mod d``;
for d = 3 this reproduces exactly the paper's final layout family

    facet_i[ii][kk][jj] [j][k]          (w_i folded away when w_i == 1)
    facet_j[jj][ii][kk] [k][i][j%w_j]
    facet_k[kk][jj][ii] [i][j][k%w_k]

and yields the paper's 4-bursts-per-3D-tile read plan.  For d >= 4 some
k-th-level neighbours cannot be merged (paper §IV-J) — the planner then simply
counts the extra bursts; nothing breaks.

Both the extension-direction assignment and the contiguity level are
*layout knobs*: ``build_facet_specs`` accepts any per-facet extension
direction and any of the three cumulative contiguity levels

    "full-tile"   §IV-G only: blocked facets, canonical inner order
    "inter-tile"  + §IV-H: extension dim first inner / last outer
    "intra-tile"  + §IV-I: modulo dim last inner (the paper's final layout)

so the layout autotuner (``repro_torch.core.cfa.autotune``) can search the whole
family rather than hard-coding the paper's single point.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import numpy as np

from .spaces import Deps, IterSpace, Tiling, facet_widths

__all__ = [
    "FacetSpec",
    "build_facet_specs",
    "extension_dir",
    "CONTIGUITY_LEVELS",
]

#: The paper's three cumulative contiguity levels (§IV-G/H/I), weakest first.
CONTIGUITY_LEVELS = ("full-tile", "inter-tile", "intra-tile")


def row_major_strides(shape: Sequence[int]) -> np.ndarray:
    """Row-major strides (elements) of ``shape`` — the one linearisation
    convention every address map in this package shares."""
    strides = np.ones(len(shape), dtype=np.int64)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]
    return strides


def extension_dir(axis: int, ndim: int) -> int:
    """Cyclic inter-tile contiguity direction ``c_k = (k+1) mod d``.

    §IV-H needs at least one projected axis to extend along, so for
    ``ndim == 1`` there is none: the convention ``c_k == k`` explicitly
    means "no extension direction" (the facet layout degenerates to
    full-tile blocks).  ``build_facet_specs`` validates that ``c_k == k``
    is only ever used in that degenerate case.  For ``ndim == 2`` the
    choice is forced: the single other axis.
    """
    if not (0 <= axis < ndim):
        raise ValueError(f"facet axis {axis} out of range for ndim={ndim}")
    if ndim == 1:
        return axis  # degenerate: no projected axes (explicit "none" marker)
    return (axis + 1) % ndim


@dataclasses.dataclass(frozen=True)
class FacetSpec:
    """Layout of one facet array (normal axis ``axis``, thickness ``width``)."""

    axis: int
    width: int
    tile_sizes: tuple[int, ...]
    num_tiles: tuple[int, ...]
    outer_axes: tuple[int, ...]  # order of tile-coordinate dims
    inner_axes: tuple[int, ...]  # order of intra-tile dims; ``axis`` = modulo dim
    ext_dir: int = -1  # inter-tile contiguity direction c_k; -1 = cyclic default

    def __post_init__(self) -> None:
        if self.ext_dir < 0:
            object.__setattr__(self, "ext_dir", extension_dir(self.axis, self.ndim))
        if not (0 <= self.ext_dir < self.ndim):
            raise ValueError(
                f"extension direction {self.ext_dir} out of range for "
                f"{self.ndim}-D facet_{self.axis}"
            )
        if self.ext_dir == self.axis and self.ndim > 1:
            raise ValueError(
                f"facet_{self.axis}: ext_dir == axis is the degenerate 1-D "
                "marker only; a d >= 2 facet must extend along a projected axis"
            )

    @property
    def ndim(self) -> int:
        return len(self.tile_sizes)

    def inner_size(self, a: int) -> int:
        return self.width if a == self.axis else self.tile_sizes[a]

    @property
    def shape(self) -> tuple[int, ...]:
        """Array shape: outer (tile) dims then inner (intra-tile) dims."""
        return tuple(self.num_tiles[a] for a in self.outer_axes) + tuple(
            self.inner_size(a) for a in self.inner_axes
        )

    @property
    def block_elems(self) -> int:
        """Elements in one tile's facet block (one burst write)."""
        return math.prod(self.inner_size(a) for a in self.inner_axes)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    # ---- address maps ----------------------------------------------------

    def domain_mask(self, pts: np.ndarray) -> np.ndarray:
        """Which iteration points lie in this facet's projection domain
        ``D(p_k) = { x : t_k - w_k <= x_k mod t_k }`` (§IV-F3)."""
        t_k = self.tile_sizes[self.axis]
        return (pts[:, self.axis] % t_k) >= (t_k - self.width)

    def coords(self, pts: np.ndarray) -> np.ndarray:
        """Facet-array multi-indices for iteration points (must be in domain).

        Applies the modulo projection ``p_k(x) = (..., x_k mod w_k, ...)``
        composed with data tiling and the dimension permutations.
        """
        pts = np.atleast_2d(np.asarray(pts, dtype=np.int64))
        if not bool(self.domain_mask(pts).all()):
            raise ValueError(f"points outside facet_{self.axis} projection domain")
        t = np.asarray(self.tile_sizes, dtype=np.int64)
        q = pts // t  # tile coordinates
        r = pts % t  # intra-tile coordinates
        cols = []
        for a in self.outer_axes:
            cols.append(q[:, a])
        for a in self.inner_axes:
            if a == self.axis:
                cols.append(pts[:, a] % self.width)  # paper's modulo projection
            else:
                cols.append(r[:, a])
        return np.stack(cols, axis=1)

    def offsets(self, pts: np.ndarray) -> np.ndarray:
        """Row-major linear offsets within the facet array for iteration points."""
        return self.coords(pts) @ row_major_strides(self.shape)

    def block_start(self, tile: Sequence[int]) -> int:
        """Linear offset of the first element of tile T's facet block."""
        strides = row_major_strides(self.shape)
        q = np.asarray(tile, dtype=np.int64)
        idx = np.array([q[a] for a in self.outer_axes], dtype=np.int64)
        return int(idx @ strides[: len(self.outer_axes)])


def _facet_axis_orders(
    k: int, c: int, d: int, contiguity: str
) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(outer_axes, inner_axes) for facet ``k`` with extension dir ``c`` at the
    requested contiguity level (levels are cumulative, §IV-G -> H -> I)."""
    if contiguity not in CONTIGUITY_LEVELS:
        raise ValueError(f"contiguity must be one of {CONTIGUITY_LEVELS}: {contiguity!r}")
    if contiguity == "full-tile" or c == k:
        # §IV-G only: blocked facet, canonical order, no extension direction.
        outer = (k, *(a for a in range(d) if a != k))
        inner = tuple(range(d))
        if contiguity == "intra-tile" and c == k:
            inner = (*(a for a in range(d) if a != k), k)
        return outer, inner
    rest = [a for a in range(d) if a not in (k, c)]
    # outer: k first (single-assignment axis), others ascending, c's tile
    # coordinate last (inter-tile contiguity, §IV-H).
    outer = (k, *rest, c)
    if contiguity == "inter-tile":
        # inner: extension dim first, remaining axes canonical.
        inner = (c, *(a for a in range(d) if a != c))
    else:
        # intra-tile (§IV-I): additionally the modulo dim (axis k) goes last.
        inner = (c, *rest, k)
    return outer, inner


def build_facet_specs(
    space: IterSpace,
    deps: Deps,
    tiling: Tiling,
    *,
    ext_dirs: Mapping[int, int] | Sequence[tuple[int, int]] | None = None,
    contiguity: str = "intra-tile",
) -> dict[int, FacetSpec]:
    """Construct a CFA facet family for a (space, deps, tiling) triple.

    ``ext_dirs`` maps facet axis -> inter-tile extension direction (defaults
    to the cyclic ``(k+1) mod d`` of the paper); ``contiguity`` selects one of
    ``CONTIGUITY_LEVELS``.  The defaults reproduce the paper's final layout.
    """
    d = space.ndim
    widths = facet_widths(deps)
    nt = tiling.num_tiles(space)
    ext = dict(ext_dirs) if ext_dirs is not None else {}
    specs: dict[int, FacetSpec] = {}
    for k in range(d):
        w = widths[k]
        if w <= 0:
            continue
        if w > tiling.sizes[k]:
            raise ValueError(
                f"facet width {w} exceeds tile size {tiling.sizes[k]} on axis {k}; "
                "tiles must be at least as deep as the dependence pattern"
            )
        c = ext.get(k, extension_dir(k, d))
        if d == 1:
            if c != k:
                raise ValueError(
                    f"1-D space: facet_{k} has no projected axis to extend "
                    f"along; the only legal value is c == k (got {c})"
                )
        elif not (0 <= c < d) or c == k:
            raise ValueError(
                f"invalid extension direction {c} for facet axis {k}: must "
                f"be a projected axis (0 <= c < {d}, c != {k})"
            )
        outer, inner = _facet_axis_orders(k, c, d, contiguity)
        specs[k] = FacetSpec(
            axis=k,
            width=w,
            tile_sizes=tuple(tiling.sizes),
            num_tiles=nt,
            outer_axes=outer,
            inner_axes=inner,
            ext_dir=c,
        )
    return specs
