"""The CFA "compiler pass" output: a read -> execute -> write tile pipeline.

Mirrors §V of the paper.  Given a :class:`StencilProgram` (post-skew normal
form), a rectangular space and a tiling, :class:`CFAPipeline` provides

* ``init_facets``  — allocate the facet arrays (plus one virtual leading
  block row on the time facet holding live-in planes),
* ``copy_in``      — gather a tile's flow-in from facets into a local halo
  buffer (the on-chip scratchpad; off-chip side reads facet blocks),
* ``execute_tile`` — run the tile's plane recurrence on the halo buffer,
* ``copy_out``     — write the tile's facet blocks (full-tile contiguity:
  each is one contiguous store),
* ``_sweep``       — the whole accelerator loop over tiles in lexicographic
  order (the legal schedule under backward dependences); the executor
  registry (``repro_torch.core.cfa.executors``) is the public way to run it.

This is the PyTorch port of the reference package's pipeline.  The static
addressing (``_halo_maps``, ``FacetSpec.offsets``, ``wavefronts``) stays
numpy; the resulting index arrays move to the pipeline's ``device`` and
every gather, scatter and plane update runs there.  Two differences from
the reference, both for memory and launch count on the card:

* facet arrays are **updated in place**: ``_commit_block`` writes the
  laid-out block into the facet tensor (``arr[idx] = block``), so
  ``copy_out``/``load_inputs`` mutate the tensors of the dict they are
  given (and return it);
* ``execute_tile`` fills the interior planes of the halo buffer it is
  given in place.

The pipeline is dimension-generic (the paper's construction is, §IV-F..J):
any d >= 2 works — one time axis plus d-1 spatial axes — so 2-D programs
(``heat1d``), the 3-D Table I suite, and 4-D programs (``heat3d``, the
§IV-J regime) all run through the same code path.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import typing
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from .facets import FacetSpec, build_facet_specs, row_major_strides
from .programs import StencilProgram
from .spaces import IterSpace, Tiling, box_points

__all__ = ["CFAPipeline"]


@dataclasses.dataclass
class CFAPipeline:
    #: facet storage discipline this pipeline realises (the irredundant /
    #: compressed variants arrive with the port's storage slice)
    storage: typing.ClassVar[str] = "redundant"

    program: StencilProgram
    space: IterSpace
    tiling: Tiling
    # layout knobs (see repro_torch.core.cfa.facets); defaults = the paper's layout
    ext_dirs: Mapping[int, int] | tuple[tuple[int, int], ...] | None = None
    contiguity: str = "intra-tile"
    # the autotuner decision this pipeline was built from, if any
    decision: object | None = dataclasses.field(default=None, repr=False, compare=False)
    # the compile-time facet->port split (single-port pipelines carry None)
    port_assignment: object | None = dataclasses.field(default=None, repr=False, compare=False)
    # runtime telemetry (repro_torch.core.cfa.obs.TraceRecorder); None =
    # tracing off, and the executors pay exactly one `is None` check per
    # phase — no recorder or span allocation on the hot path
    recorder: object | None = dataclasses.field(default=None, repr=False, compare=False)
    # where facets, halo buffers and plane updates live
    device: torch.device | str = "cuda"
    specs: Mapping[int, FacetSpec] = dataclasses.field(init=False)
    num_tiles: tuple[int, ...] = dataclasses.field(init=False)

    def __post_init__(self) -> None:
        if self.space.ndim < 2:
            raise ValueError(
                "the executor needs a time axis plus at least one spatial "
                f"axis (d >= 2); got a {self.space.ndim}-D space"
            )
        if self.program.ndim != self.space.ndim:
            raise ValueError(
                f"program {self.program.name!r} is {self.program.ndim}-D but "
                f"the space is {self.space.ndim}-D"
            )
        self.device = torch.device(self.device)
        self.specs = build_facet_specs(
            self.space, self.program.deps, self.tiling,
            ext_dirs=dict(self.ext_dirs) if self.ext_dirs is not None else None,
            contiguity=self.contiguity,
        )
        self.num_tiles = self.tiling.num_tiles(self.space)
        if 0 not in self.specs:
            raise ValueError("time axis must carry a facet (w_0 >= 1)")

    def _index(self, idx: np.ndarray) -> torch.Tensor:
        """A numpy index array as an int64 tensor on the pipeline's device."""
        return torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int64)).to(self.device)

    # -- storage -----------------------------------------------------------

    def facet_shape(self, k: int) -> tuple[int, ...]:
        shape = list(self.specs[k].shape)
        if k == 0:
            shape[0] += 1  # virtual leading block row for live-in planes
        return tuple(shape)

    def init_facets(self, dtype=torch.float32) -> dict[int, torch.Tensor]:
        return {k: torch.zeros(self.facet_shape(k), dtype=dtype, device=self.device)
                for k in self.specs}

    def load_inputs(
        self, facets: dict[int, torch.Tensor], inputs: torch.Tensor
    ) -> dict[int, torch.Tensor]:
        """Pack live-in planes (w_0, N_1, .., N_{d-1}) into the virtual
        facet_0 row (in place)."""
        spec = self.specs[0]
        w0 = spec.width
        if tuple(inputs.shape) != (w0, *self.space.sizes[1:]):
            raise ValueError(f"inputs must be {(w0, *self.space.sizes[1:])}")
        f0 = facets[0]
        t = self.tiling.sizes
        for q in itertools.product(*(range(n) for n in self.num_tiles[1:])):
            sl = tuple(
                slice(q[a - 1] * t[a], (q[a - 1] + 1) * t[a])
                for a in range(1, self.space.ndim)
            )
            blk = inputs[(slice(None), *sl)]
            f0 = self._store_block(f0, spec, (-1, *q), blk, virtual=True)
        facets = dict(facets)
        facets[0] = f0
        return facets

    # -- block addressing ----------------------------------------------------

    def _block_index(self, spec: FacetSpec, tile: tuple[int, ...], virtual: bool):
        idx = []
        for a in spec.outer_axes:
            q = tile[a]
            if spec.axis == 0 and a == 0:
                q += 1  # shift for the virtual live-in row
            idx.append(q)
        return tuple(idx)

    def _store_block(self, arr, spec: FacetSpec, tile, slab, *, virtual=False):
        """``slab`` has canonical axis order with axis ``spec.axis`` of size w
        indexed by slab position; store it permuted to the facet block layout
        with the paper's (tile-dependent, in general) modulo labelling."""
        k, w, t_k = spec.axis, spec.width, spec.tile_sizes[spec.axis]
        x0 = tile[k] * t_k + t_k - w if not virtual else -w
        perm = np.argsort([(x0 + j) % w for j in range(w)])  # m -> slab j
        if (perm != np.arange(w)).any():  # the identity needs no gather
            slab = slab.index_select(k, self._index(perm))
        block = slab.permute(*spec.inner_axes)
        return self._commit_block(arr, self._block_index(spec, tile, virtual),
                                  block, spec)

    def _commit_block(self, arr, idx, block, spec: FacetSpec):
        """Write one laid-out facet block at its outer index, in place (the
        reference's ``arr.at[idx].set(block)``)."""
        arr[idx] = block
        return arr

    # -- copy-in -------------------------------------------------------------

    def _halo_maps(self, tile: tuple[int, ...]):
        """Static gather maps: halo point -> (facet id, flat offset).

        Halo = points of [lo - w, hi) with some coordinate below lo.  Points
        with x_0 < 0 come from the virtual live-in row; points outside the
        space elsewhere keep the zero boundary value.
        """
        d = self.space.ndim
        w = np.array([self.specs[a].width if a in self.specs else 0 for a in range(d)])
        lo = np.array(tile) * np.array(self.tiling.sizes)
        hi = lo + np.array(self.tiling.sizes)
        pts = box_points(lo - w, hi)
        below = (pts < lo).any(axis=1)
        pts = pts[below]
        # spatially out-of-space points are zero-boundary; x_0 < 0 is live-in
        in_space = np.ones(len(pts), dtype=bool)
        for a in range(1, d):
            in_space &= (pts[:, a] >= 0) & (pts[:, a] < self.space.sizes[a])
        in_space &= pts[:, 0] < self.space.sizes[0]
        pts = pts[in_space]
        maps = {}
        taken = np.zeros(len(pts), dtype=bool)
        # virtual live-in reads
        virt = pts[:, 0] < 0
        if virt.any():
            maps["virtual"] = pts[virt]
            taken |= virt
        maps.update(self._halo_hosts(pts, lo, taken))
        if not bool(taken.all()):
            raise AssertionError("halo point not covered by any facet — layout bug")
        return maps, lo, w

    def _halo_hosts(self, pts, lo, taken):
        """Assign each non-virtual halo point to the facet it is read from:
        under redundant storage, the first facet crossed along its own axis
        whose domain contains the point (any copy is valid — they are all
        written).  ``taken`` is updated in place."""
        maps = {}
        for k, spec in self.specs.items():
            mask = ~taken & (pts[:, k] < lo[k]) & (pts[:, k] >= 0) & spec.domain_mask(pts)
            if mask.any():
                maps[k] = pts[mask]
                taken |= mask
        return maps

    def copy_in(self, facets: dict[int, torch.Tensor], tile: tuple[int, ...]) -> torch.Tensor:
        """Gather the tile's flow-in into a halo buffer of shape (w + t).

        All of the tile's source and destination offsets are computed on the
        host, moved to the device as one index tensor, and applied as one
        gather per facet and one scatter into the (zero-initialised) buffer.
        """
        rec = self.recorder
        t_start = rec.now() if rec is not None else 0.0
        maps, lo, w = self._halo_maps(tile)
        if rec is not None:
            rec.add_span("halo_resolve", t_start, rec.now(),
                         track=rec.track("fetch"), tile=list(tile),
                         wave=int(sum(tile)), port=rec.port,
                         **rec.record_halo(self, maps))
        t = np.array(self.tiling.sizes)
        shape = tuple(int(x) for x in w + t)
        keys, srcs, dsts = [], [], []
        for key, pts in maps.items():
            if key == "virtual":
                offs = self._virtual_offsets(self.specs[0], pts)
                key = 0
            else:
                spec = self.specs[key]
                offs = spec.offsets(pts)
                if key == 0:  # account for the virtual leading row
                    offs = offs + spec.block_elems * math.prod(
                        spec.num_tiles[a] for a in spec.outer_axes[1:]
                    )
            keys.append(key)
            srcs.append(offs)
            dsts.append((pts - (lo - w)) @ row_major_strides(shape))
        H = torch.zeros(shape, dtype=facets[0].dtype, device=self.device)
        if keys:
            idx = self._index(np.concatenate(srcs + dsts))
            src_idx = idx[:idx.numel() // 2]
            vals = torch.cat([
                facets[key].reshape(-1)[part] for key, part in zip(
                    keys, torch.split(src_idx, [len(s) for s in srcs]))
            ])
            H.view(-1)[idx[idx.numel() // 2:]] = vals
        if rec is not None:
            rec.add_span("copy_in", t_start, rec.now(),
                         track=rec.track("fetch"),
                         **rec.record_read(self, tile))
        return H

    def _virtual_offsets(self, spec: FacetSpec, pts: np.ndarray) -> np.ndarray:
        """Flat facet_0 offsets of live-in points (x_0 < 0) in the virtual
        row — the addressing of the reference's ``_gather_virtual``, whose
        gather ``copy_in`` batches with the other facets'."""
        w = spec.width
        idx_cols = []
        shape = self.facet_shape(0)
        for a in spec.outer_axes:
            idx_cols.append(
                np.zeros(len(pts), np.int64) if a == 0 else pts[:, a] // spec.tile_sizes[a]
            )
        for a in spec.inner_axes:
            if a == 0:
                idx_cols.append(pts[:, 0] % w)  # matches the store perm for x0=-w..-1
            else:
                idx_cols.append(pts[:, a] % spec.tile_sizes[a])
        idx = np.stack(idx_cols, axis=1)
        return idx @ row_major_strides(shape)

    # -- execute ---------------------------------------------------------------

    @property
    def widths(self) -> tuple[int, ...]:
        """Facet width per axis (0 for axes that carry no facet)."""
        return tuple(
            self.specs[a].width if a in self.specs else 0
            for a in range(self.space.ndim)
        )

    def _interior_slices(self, w: tuple[int, ...]) -> tuple[slice, ...]:
        """Index of the tile interior within a (w + t)-shaped halo buffer."""
        return tuple(slice(w[a], None) for a in range(self.space.ndim))

    def execute_tile(self, H: torch.Tensor) -> torch.Tensor:
        """Run the plane recurrence over the halo buffer; the interior planes
        are computed in place and the buffer is returned."""
        w = self.widths
        t = self.tiling.sizes
        depth = w[0]
        spatial = self._interior_slices(w)[1:]
        for s in range(t[0]):
            prev = [H[w[0] + s - m] for m in range(depth, 0, -1)]
            plane = self.program.plane_update(prev, w)
            H[(w[0] + s, *spatial)] = plane
        return H

    # -- copy-out ---------------------------------------------------------------

    def copy_out(
        self, facets: dict[int, torch.Tensor], tile: tuple[int, ...], H: torch.Tensor
    ) -> dict[int, torch.Tensor]:
        rec = self.recorder
        t_start = rec.now() if rec is not None else 0.0
        w = self.widths
        t = self.tiling.sizes
        interior = H[self._interior_slices(w)]
        out = dict(facets)
        for k, spec in self.specs.items():
            sl = [slice(None)] * self.space.ndim
            sl[k] = slice(t[k] - spec.width, t[k])
            out[k] = self._store_block(out[k], spec, tile, interior[tuple(sl)])
        if rec is not None:
            rec.add_span("copy_out", t_start, rec.now(),
                         track=rec.track("commit"),
                         **rec.record_write(self, tile))
        return out

    # -- full sweep ----------------------------------------------------------------

    def _prepare(self, inputs, dtype) -> dict[int, torch.Tensor]:
        """Fresh facet storage on the device with the live-in planes packed."""
        inputs = torch.as_tensor(inputs).to(device=self.device, dtype=dtype)
        return self.load_inputs(self.init_facets(dtype), inputs)

    def _sweep(self, inputs: torch.Tensor, dtype=torch.float32) -> dict[int, torch.Tensor]:
        """Run the whole tiled computation through facet storage (the
        ``backend="sweep"`` executor's entry point)."""
        rec = self.recorder
        facets = self._prepare(inputs, dtype)
        if rec is not None:
            rec.counters.add("waves", len(self.wavefronts()))
        for tile in itertools.product(*(range(n) for n in self.num_tiles)):
            H = self.copy_in(facets, tile)
            if rec is None:
                H = self.execute_tile(H)
            else:
                with rec.span("execute_tile", track=rec.track("compute"),
                              tile=list(tile), wave=int(sum(tile))):
                    H = self.execute_tile(H)
            facets = self.copy_out(facets, tile, H)
        return facets

    # -- wavefront-parallel sweep ------------------------------------------------

    def wavefronts(self) -> list[list[tuple[int, ...]]]:
        """Tiles grouped by wavefront (sum of tile coordinates).

        All backward-neighbour dependencies strictly decrease the coordinate
        sum, so tiles within one wavefront are independent — the tile-level
        parallelism the paper's task pipeline generalises to on a machine
        with many cores/ports."""
        waves: dict[int, list[tuple[int, ...]]] = {}
        for tile in itertools.product(*(range(n) for n in self.num_tiles)):
            waves.setdefault(sum(tile), []).append(tile)
        return [waves[s] for s in sorted(waves)]

    def _sweep_wavefront(self, inputs: torch.Tensor, dtype=torch.float32,
                         use_kernel: bool = False) -> dict[int, torch.Tensor]:
        """Wavefront-parallel sweep: each wave's tiles execute as one batch
        (through the hand-written CUDA tile executor when ``use_kernel``:
        one launch per wave) — the ``backend="wavefront"``/``"cuda"``
        executors' entry point."""
        rec = self.recorder
        facets = self._prepare(inputs, dtype)
        interior = self._interior_slices(self.widths)
        waves = self.wavefronts()
        if rec is not None:
            rec.counters.add("waves", len(waves))
        for wave in waves:
            halos = torch.stack([self.copy_in(facets, t) for t in wave])
            tok = rec.begin("execute_wave", track=rec.track("compute"),
                            wave=int(sum(wave[0])), n_tiles=len(wave),
                            tiles=[list(t) for t in wave],
                            ) if rec is not None else None
            if use_kernel:
                from repro_torch.kernels.stencil import execute_tiles

                interiors = execute_tiles(self.program.name, halos,
                                          self.tiling.sizes)
                halos[(slice(None), *interior)] = interiors
                outs = list(halos)
            else:
                outs = [self.execute_tile(halos[i]) for i in range(len(wave))]
            if tok is not None:
                rec.end(tok)
            for tile, H in zip(wave, outs):
                facets = self.copy_out(facets, tile, H)
        return facets

    # -- oracle ----------------------------------------------------------------

    def reference_volume(self, inputs: torch.Tensor) -> torch.Tensor:
        """Untiled plane-by-plane sweep over the full space (the oracle)."""
        inputs = torch.as_tensor(inputs).to(self.device)
        w = self.widths
        N = self.space.sizes
        depth = w[0]
        # low side only; F.pad lists its pads last axis first
        pad = []
        for a in reversed(range(1, self.space.ndim)):
            pad += [w[a], 0]
        hist = [inputs[m] for m in range(depth)]  # planes -w0..-1
        planes = []
        for _ in range(N[0]):
            padded = [F.pad(h, pad) for h in hist]
            new = self.program.plane_update(padded, w)
            planes.append(new)
            hist = hist[1:] + [new] if depth > 1 else [new]
        return torch.stack(planes)
