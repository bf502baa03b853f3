"""The paper's Table I benchmark suite as uniform-dependence program specs.

Each program is given in the *post-skew normal form* the paper assumes
(§IV-E: "we expect such a pre-processing to have been done"): a rectangular
iteration space with all dependence vectors backwards in every dimension.
The skew applied to each classic benchmark is recorded in ``skew`` so that
tests can relate the skewed recurrence back to the textbook stencil.

Iteration semantics: axis 0 is the (skewed) time axis; ``plane_update``
computes the value plane at time ``s`` from the ``depth`` previous planes,
where each previous plane is passed *with its backward halo attached* (halo
width ``w_a`` on the low side of each spatial axis ``a``).  Out-of-space
reads are zero (Dirichlet boundary), making the recurrence total on the
rectangular space.

The suite is dimension-generic: a program's iteration space is d-dimensional
(time + d-1 spatial axes) and planes are (d-1)-dimensional.  Besides the 3-D
Table I benchmarks, the registry carries ``heat1d`` (a 1-D heat equation as
a 2-D tiled space) and ``heat3d`` (a 3-D spatial heat equation as a 4-D
space — the §IV-J regime where some k-th-level neighbours no longer merge
into one burst).

``plane_update`` works on tensors, on any device.  The arithmetic order is
part of the contract: weighted sums accumulate ``acc = v0*c0; acc = acc +
v1*c1; ...`` in table order with each coefficient a Python ``float`` (so a
float32 plane rounds it to float32), which is what keeps the port bit-exact
against the reference package and the CUDA tile kernel bit-exact against
this plain version.  Every program is also described by a :class:`TermTable`
(:func:`term_table`) — the flat form the CUDA kernel evaluates.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from .spaces import Deps, IterSpace, Tiling, facet_widths

__all__ = ["StencilProgram", "PROGRAMS", "get_program", "TermTable", "term_table"]

#: combine modes of a :class:`TermTable`
COMBINE_SUM, COMBINE_MAXPLUS, COMBINE_GOL = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class StencilProgram:
    """A uniform-dependence benchmark in post-skew normal form."""

    name: str
    deps: Deps
    default_tile: tuple[int, ...]
    paper_tiles: tuple[tuple[int, ...], ...]  # Table I tile-size sweep corners
    equivalent_app: str
    skew: tuple[int, ...]  # spatial skew factors applied per spatial axis
    # update: (prev_planes [depth][spatial+halo], widths) -> new plane [spatial]
    plane_update: Callable[[Sequence[torch.Tensor], tuple[int, ...]], torch.Tensor]

    @property
    def ndim(self) -> int:
        return self.deps.ndim

    @property
    def widths(self) -> tuple[int, ...]:
        return facet_widths(self.deps)

    def space(self, sizes: Sequence[int]) -> IterSpace:
        return IterSpace(tuple(sizes))

    def tiling(self, sizes: Sequence[int] | None = None) -> Tiling:
        return Tiling(tuple(sizes) if sizes is not None else self.default_tile)


def _shiftn(prev: torch.Tensor, offs: Sequence[int], w: tuple[int, ...]) -> torch.Tensor:
    """Read ``prev`` (a (d-1)-D plane with low-side halo ``w[1:]``) at the
    spatial offset vector ``offs`` (all components <= 0), returning the
    interior-sized plane (a view).  Leading axes beyond the plane's own
    ``len(offs)`` are batch axes and are kept whole."""
    nb = prev.dim() - len(offs)
    sl = tuple(
        slice(w[a + 1] + o, w[a + 1] + o + (prev.shape[nb + a] - w[a + 1]))
        for a, o in enumerate(offs)
    )
    return prev[(Ellipsis, *sl)]


def _shift2(prev: torch.Tensor, di: int, dj: int, w: tuple[int, ...]) -> torch.Tensor:
    """Read ``prev`` (with low-side halo (w1, w2)) at spatial offset (di, dj),
    di, dj <= 0, returning the interior-sized plane."""
    return _shiftn(prev, (di, dj), w)


def _jacobi_update(offsets: Sequence[tuple[int, ...]], coeffs: Sequence[float]):
    """Depth-1 weighted-sum update over spatial offsets, any dimension."""
    def update(prev_planes: Sequence[torch.Tensor], w: tuple[int, ...]) -> torch.Tensor:
        p = prev_planes[-1]  # plane s-1 (depth-1 history used by jacobi family)
        acc = None
        for off, c in zip(offsets, coeffs):
            v = _shiftn(p, off, w) * float(c)  # python float: no promotion
            acc = v if acc is None else acc + v
        return acc

    return update


# --- jacobi2d5p: 5-point Laplace; skew (1,1) -> deps (-1, di-1, dj-1) -------
_J5_OFF = [(-1, -1), (0, -1), (-2, -1), (-1, 0), (-1, -2)]
_J5 = Deps(tuple((-1, a, b) for a, b in _J5_OFF))
_J5_C = [0.2] * 5

# --- jacobi2d9p: 3x3 convolution; skew (1,1) --------------------------------
_J9_OFF = [(a - 1, b - 1) for a in (-1, 0, 1) for b in (-1, 0, 1)]
_J9 = Deps(tuple((-1, a, b) for a, b in _J9_OFF))
_J9_C = [1.0 / 9.0] * 9

# --- gaussian: 5x5 blur; skew (2,2) -> 25 deps ------------------------------
_GA_OFF = [(a - 2, b - 2) for a in range(-2, 3) for b in range(-2, 3)]
_GA = Deps(tuple((-1, a, b) for a, b in _GA_OFF))
_GA_K = np.outer([1, 4, 6, 4, 1], [1, 4, 6, 4, 1]).astype(np.float64)
_GA_K /= _GA_K.sum()
_GA_C = [float(c) for c in _GA_K.ravel()]

# --- heat1d: 1-D heat equation as a 2-D tiled space; skew (1) ---------------
# textbook: u[t,x] = a*u[t-1,x-1] + (1-2a)*u[t-1,x] + a*u[t-1,x+1]; skewing
# x by t maps the offsets dx in (-1, 0, 1) to backward vectors (-1, dx-1).
_H1_OFF = [(-2,), (-1,), (0,)]
_H1 = Deps(tuple((-1, *o) for o in _H1_OFF))
_H1_A = 0.25  # diffusion number; coeffs (a, 1-2a, a)
_H1_C = [_H1_A, 1 - 2 * _H1_A, _H1_A]

# --- heat3d: 3-D spatial heat equation as a 4-D space; skew (1,1,1) ---------
# 7-point stencil: centre + one neighbour per spatial axis and direction;
# skewing each spatial axis by t maps offset d in {-1,0,1} to d-1 on that
# axis.  This is the d >= 4 regime of §IV-J: level-2/3 neighbour pieces
# whose crossed axes miss every candidate facet's extension direction can
# no longer merge into an existing burst.
_H3_OFF = [(0, 0, 0)] + [
    tuple(s if a == ax else 0 for a in range(3))
    for ax in range(3) for s in (-1, 1)
]
_H3 = Deps(tuple((-1, *(c - 1 for c in o)) for o in _H3_OFF))
_H3_A = 0.1  # coeffs: centre 1-6a, each neighbour a
_H3_SOFF = [tuple(c - 1 for c in o) for o in _H3_OFF]
_H3_C = [1 - 6 * _H3_A] + [_H3_A] * 6


# --- smith-waterman-3seq: 3-sequence alignment; skew s = i+j+k --------------
# original deps: the 7 nonzero corners of {0,-1}^3; skewed by s = i+j+k they
# become (sum, j, k)-space vectors, all strictly backwards on axis 0.
_SW_RAW = [
    (-1, 0, 0), (0, -1, 0), (0, 0, -1),
    (-1, -1, 0), (-1, 0, -1), (0, -1, -1), (-1, -1, -1),
]
_SW = Deps(tuple((a + b + c, b, c) for a, b, c in _SW_RAW))
# (plane distance, (j, k) offset, additive score), in candidate order
_SW_TERMS = [
    (1, (0, 0), 1.0), (1, (-1, 0), 1.0), (1, (0, -1), 1.0),
    (2, (-1, 0), 2.0), (2, (0, -1), 2.0), (2, (-1, -1), 2.0),
    (3, (-1, -1), 3.0),
]


def _sw_update(prev_planes: Sequence[torch.Tensor], w: tuple[int, ...]) -> torch.Tensor:
    """Max-plus alignment recurrence on the skewed lattice (depth 3)."""
    # deps at axis-0 distance 1: (j,k) offsets (0,0),(-1,0),(0,-1)
    # distance 2: (-1,0),(0,-1),(-1,-1);   distance 3: (-1,-1)
    out = None
    for m, (dj, dk), score in _SW_TERMS:
        c = _shift2(prev_planes[-m], dj, dk, w) + score
        out = c if out is None else torch.maximum(out, c)
    return out


def _gol_update(prev_planes: Sequence[torch.Tensor], w: tuple[int, ...]) -> torch.Tensor:
    """2nd-order finite difference flavoured 9-point update (jacobi2d9p-gol)."""
    p = prev_planes[-1]
    neigh = None
    for (di, dj) in _J9_OFF:
        v = _shift2(p, di, dj, w)
        neigh = v if neigh is None else neigh + v
    centre = _shift2(p, -1, -1, w)
    # divide by a 0-d tensor on the plane's device, not by a Python scalar:
    # CUDA PyTorch turns division by a host scalar into multiplication by its
    # rounded reciprocal, which is not the IEEE quotient the CPU (and the
    # reference package, and the CUDA tile kernel) compute
    return 2.0 * centre - neigh / neigh.new_tensor(9.0)


PROGRAMS: dict[str, StencilProgram] = {
    "jacobi2d5p": StencilProgram(
        name="jacobi2d5p",
        deps=_J5,
        default_tile=(16, 16, 16),
        paper_tiles=((16, 16, 16), (32, 32, 32), (64, 64, 64), (128, 128, 128)),
        equivalent_app="Laplace equation",
        skew=(1, 1),
        plane_update=_jacobi_update(_J5_OFF, _J5_C),
    ),
    "jacobi2d9p": StencilProgram(
        name="jacobi2d9p",
        deps=_J9,
        default_tile=(16, 16, 16),
        paper_tiles=((16, 16, 16), (32, 32, 32), (64, 64, 64), (128, 128, 128)),
        equivalent_app="3x3 convolution",
        skew=(1, 1),
        plane_update=_jacobi_update(_J9_OFF, _J9_C),
    ),
    "jacobi2d9p-gol": StencilProgram(
        name="jacobi2d9p-gol",
        deps=_J9,
        default_tile=(16, 16, 16),
        paper_tiles=((16, 16, 16), (32, 32, 32), (64, 64, 64), (128, 128, 128)),
        equivalent_app="2nd-order finite difference",
        skew=(1, 1),
        plane_update=_gol_update,
    ),
    "gaussian": StencilProgram(
        name="gaussian",
        deps=_GA,
        default_tile=(4, 16, 16),
        paper_tiles=((4, 16, 16), (4, 32, 32), (4, 64, 64), (4, 128, 128)),
        equivalent_app="5x5 Gaussian Blur",
        skew=(2, 2),
        plane_update=_jacobi_update(_GA_OFF, _GA_C),
    ),
    "smith-waterman-3seq": StencilProgram(
        name="smith-waterman-3seq",
        deps=_SW,
        default_tile=(16, 16, 16),
        paper_tiles=((16, 16, 16), (32, 32, 32), (64, 64, 64), (128, 128, 128)),
        equivalent_app="Alignment of 3 sequences",
        skew=(0, 0),  # skew folded into axis 0 = i+j+k
        plane_update=_sw_update,
    ),
    # -- beyond Table I: non-3-D workloads (the N-D executor path) ----------
    "heat1d": StencilProgram(
        name="heat1d",
        deps=_H1,
        default_tile=(8, 8),
        paper_tiles=((8, 8), (16, 16), (32, 32), (64, 64)),
        equivalent_app="1-D heat equation (2-D tiled space)",
        skew=(1,),
        plane_update=_jacobi_update(_H1_OFF, _H1_C),
    ),
    "heat3d": StencilProgram(
        name="heat3d",
        deps=_H3,
        default_tile=(4, 4, 4, 4),
        paper_tiles=((4, 4, 4, 4), (2, 4, 4, 4), (4, 8, 8, 8)),
        equivalent_app="3-D heat equation (4-D tiled space, §IV-J regime)",
        skew=(1, 1, 1),
        plane_update=_jacobi_update(_H3_SOFF, _H3_C),
    ),
}


def get_program(name: str) -> StencilProgram:
    try:
        return PROGRAMS[name]
    except KeyError:
        raise KeyError(f"unknown benchmark {name!r}; have {sorted(PROGRAMS)}") from None


# --------------------------------------------------------------------------
# The flat term table (what the CUDA tile kernel evaluates)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TermTable:
    """A program's plane update as a flat list of terms, in evaluation order.

    Term ``i`` reads the plane ``depth[i]`` steps back (1 = the previous
    plane) at the spatial offset ``offsets[i]`` (components <= 0) and
    combines it with ``values[i]`` according to ``combine``:

    * ``COMBINE_SUM`` — ``acc = v0*c0; acc = acc + v_i*c_i`` (the jacobi
      family, gaussian, heat1d/heat3d);
    * ``COMBINE_MAXPLUS`` — ``out = max_i(v_i + c_i)`` (smith-waterman);
    * ``COMBINE_GOL`` — ``neigh = v0 + v1 + ...`` over every term, then
      ``2.0 * centre - neigh / 9.0`` with ``centre`` the term at
      ``offsets[centre]`` (``values`` unused).
    """

    combine: int
    depth: tuple[int, ...]
    offsets: tuple[tuple[int, ...], ...]
    values: tuple[float, ...]
    centre: int = -1


def term_table(program: "StencilProgram | str") -> TermTable:
    """The :class:`TermTable` of a registered program."""
    name = program if isinstance(program, str) else program.name
    if name in ("jacobi2d5p", "jacobi2d9p", "gaussian", "heat1d", "heat3d"):
        offs, coeffs = {
            "jacobi2d5p": (_J5_OFF, _J5_C),
            "jacobi2d9p": (_J9_OFF, _J9_C),
            "gaussian": (_GA_OFF, _GA_C),
            "heat1d": (_H1_OFF, _H1_C),
            "heat3d": (_H3_SOFF, _H3_C),
        }[name]
        return TermTable(COMBINE_SUM, (1,) * len(offs),
                         tuple(tuple(o) for o in offs),
                         tuple(float(c) for c in coeffs))
    if name == "smith-waterman-3seq":
        return TermTable(COMBINE_MAXPLUS, tuple(m for m, _, _ in _SW_TERMS),
                         tuple(o for _, o, _ in _SW_TERMS),
                         tuple(s for _, _, s in _SW_TERMS))
    if name == "jacobi2d9p-gol":
        return TermTable(COMBINE_GOL, (1,) * len(_J9_OFF),
                         tuple(tuple(o) for o in _J9_OFF),
                         (0.0,) * len(_J9_OFF), centre=_J9_OFF.index((-1, -1)))
    raise KeyError(f"no term table for {name!r}; have {sorted(PROGRAMS)}")
