"""Plain PyTorch version of the CFA read engine (interior-tile halo fetch).

Assembles every interior tile's ``(w0+t0, w1+t1, w2+t2)`` halo buffer from
facet blocks, exactly as the reference package's Pallas kernel does
(``repro/kernels/facet_fetch/facet_fetch.py``): the seven pieces of
``_assemble`` and, under irredundant storage, the four owner-block
overwrites of ``_kernel_irredundant``, in the same order.  The reference's
grid over interior tiles becomes leading batch dimensions: each piece is
one strided slice of a facet array (the kernel's ``BlockSpec`` index map
shifted over all tiles at once), permuted from the facet's inner order to
canonical order.

This is the version the CUDA kernel (``facet_fetch.py``) is held against
on the card, and what its wrapper runs for tensors on the CPU.  It works
on any dtype (the function is pure data movement).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.cfa.facets import FacetSpec, build_facet_specs
from repro_torch.core.cfa.programs import get_program
from repro_torch.core.cfa.spaces import IterSpace, Tiling

__all__ = ["FetchGeometry", "fetch_geometry", "fetch_interior_halos_ref"]

#: facet axis -> (outer_axes, inner_axes) of the paper's default 3-D layout,
#: the block orders the reference kernel's BlockSpecs address
_DEFAULT_ORDERS = {0: ((0, 2, 1), (1, 2, 0)),
                   1: ((1, 0, 2), (2, 0, 1)),
                   2: ((2, 1, 0), (0, 1, 2))}


class FetchGeometry(NamedTuple):
    """A validated fetch: facet specs, widths, tile, interior tiles per axis."""

    specs: dict[int, FacetSpec]
    w: tuple[int, int, int]
    t: tuple[int, int, int]
    g: tuple[int, int, int]


def fetch_geometry(program_name: str, facets: dict, space, tile,
                   storage: str) -> FetchGeometry:
    """Validate a fetch request; the rejections and messages of the
    reference wrapper, plus a check of the facet arrays against the paper's
    default layout (the facet shapes and block orders both versions
    address)."""
    prog = get_program(program_name)
    space, tile = tuple(int(n) for n in space), tuple(int(x) for x in tile)
    if len(space) != 3 or prog.ndim != 3:
        raise ValueError(
            "the facet_fetch kernel's static BlockSpecs address 3-D facet "
            f"layouts only (got a {len(space)}-D space); non-3-D programs "
            "take CFAPipeline.copy_in / kernels.stencil instead"
        )
    if storage not in ("redundant", "irredundant"):
        raise ValueError(
            f"the facet_fetch kernel has no in-kernel decode stage: storage "
            f"must be 'redundant' or 'irredundant', got {storage!r}"
        )
    specs = build_facet_specs(IterSpace(space), prog.deps, Tiling(tile))
    w = tuple(specs[a].width if a in specs else 0 for a in range(3))
    t = tile
    for a in range(3):
        if w[a] and t[a] % w[a]:
            raise ValueError(
                f"kernel fetch requires w | t (axis {a}: t={t[a]}, w={w[a]}); "
                "tile-dependent modulo labelling takes the CFAPipeline.copy_in "
                "path")
    nt = tuple(n // x for n, x in zip(space, tile))
    g = (nt[0] - 1, nt[1] - 1, nt[2] - 1)
    if min(g) < 1:
        raise ValueError("need at least 2 tiles per axis for interior fetch")
    if sorted(specs) != [0, 1, 2]:
        raise ValueError(f"{program_name}: the fetch needs a facet on every "
                         f"axis, got facets {sorted(specs)}")
    for k, spec in specs.items():
        if (spec.outer_axes, spec.inner_axes) != _DEFAULT_ORDERS[k]:
            raise ValueError(f"facet_{k}: not the paper's default layout")
        want = (spec.shape[0] + (k == 0), *spec.shape[1:])  # + virtual row
        if k not in facets or tuple(facets[k].shape) != want:
            got = tuple(facets[k].shape) if k in facets else None
            raise ValueError(f"facet_{k} must have shape {want} (the default "
                             f"layout at tile {t}), got {got}")
    dtypes = {facets[k].dtype for k in range(3)}
    if len(dtypes) != 1:
        raise TypeError(f"facets must share one dtype, got {sorted(map(str, dtypes))}")
    return FetchGeometry(specs, w, t, g)


def _assemble_interior(f0: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                       w, t, g, storage: str) -> torch.Tensor:
    w0, w1, w2 = w
    t0, t1, t2 = t
    g0, g1, g2 = g

    # facet_0 (nt0+1, nt2, nt1, t1, t2, w0): tile (a, b, c) at (a+1, c, b);
    # the reference reads grid cell (i, j, k) at (i+1+da, k+1+dc, j+1+db)
    def blk0(da, db, dc):  # -> (g0, g1, g2, w0, t1, t2)
        return f0[1 + da:1 + da + g0, 1 + dc:1 + dc + g2,
                  1 + db:1 + db + g1].permute(0, 2, 1, 5, 3, 4)

    # facet_1 (nt1, nt0, nt2, t2, t0, w1): cell (i, j, k) at (j+db, i+1, k+1+dc)
    def blk1(db, dc):  # -> (g0, g1, g2, t0, w1, t2)
        return f1[db:db + g1, 1:1 + g0,
                  1 + dc:1 + dc + g2].permute(1, 0, 2, 4, 5, 3)

    # facet_2 (nt2, nt1, nt0, t0, t1, w2): cell (i, j, k) at (k, j+1, i+1)
    f2a = f2[0:g2, 1:1 + g1, 1:1 + g0].permute(2, 1, 0, 3, 4, 5)

    H = f0.new_zeros((g0, g1, g2, w0 + t0, w1 + t1, w2 + t2))
    # _assemble: the seven pieces
    H[..., :w0, w1:, w2:] = blk0(0, 0, 0)                        # time halo
    H[..., w0:, :w1, w2:] = blk1(0, 0)                           # x1 halo
    H[..., w0:, w1:, :w2] = f2a                                  # x2 halo
    H[..., :w0, :w1, w2:] = blk0(0, -1, 0)[..., t1 - w1:, :]     # x0/x1 corner
    H[..., :w0, w1:, :w2] = blk0(0, 0, -1)[..., t2 - w2:]        # x0/x2 corner
    H[..., w0:, :w1, :w2] = blk1(0, -1)[..., t2 - w2:]           # x1/x2 corner
    H[..., :w0, :w1, :w2] = blk0(0, -1, -1)[..., t1 - w1:, t2 - w2:]  # S3
    if storage == "irredundant":
        # _kernel_irredundant: owner blocks over the dead sub-regions,
        # lowest priority first (the last writer wins)
        H[..., t0:, :w1, w2:] = blk0(1, -1, 0)[..., t1 - w1:, :]
        H[..., w0:, t1:, :w2] = blk1(1, -1)[..., t2 - w2:]
        H[..., t0:, w1:, :w2] = blk0(1, 0, -1)[..., t2 - w2:]
        H[..., t0:, :w1, :w2] = blk0(1, -1, -1)[..., t1 - w1:, t2 - w2:]
    return H


def fetch_interior_halos_ref(
    program_name: str,
    facets: dict,
    space: tuple[int, int, int],
    tile: tuple[int, int, int],
    *,
    storage: str = "redundant",
) -> torch.Tensor:
    """Halo buffers of all interior tiles, assembled block-wise;
    ``(n0-1, n1-1, n2-1, w0+t0, w1+t1, w2+t2)``, entry (i, j, k) for tile
    (i+1, j+1, k+1), on the facets' device."""
    geo = fetch_geometry(program_name, facets, space, tile, storage)
    return _assemble_interior(facets[0], facets[1], facets[2],
                              geo.w, geo.t, geo.g, storage)
