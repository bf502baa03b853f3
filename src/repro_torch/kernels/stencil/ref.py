"""Plain PyTorch version of the CFA stencil tile executor.

Given a batch of halo buffers (flow-in gathered from facet arrays, low-side
halo of width ``w`` per axis), compute the tiles' interior planes with the
program's plane recurrence.  This is the version the CUDA kernel
(``stencil.py``) is held against on the card, and what its wrapper runs for
tensors on the CPU.  It is the reference package's ``execute_tiles_ref``
with the batch written out instead of ``vmap``-ed: every plane update runs
once over the whole batch, with the same arithmetic order as
``CFAPipeline.execute_tile``.
"""
from __future__ import annotations

import torch

from repro_torch.core.cfa.programs import StencilProgram, get_program

__all__ = ["execute_tiles_ref"]


def execute_tiles_ref(
    program: StencilProgram | str,
    halos: torch.Tensor,  # (B, w0+t0, .., w_{d-1}+t_{d-1})
    tile: tuple[int, ...],
) -> torch.Tensor:  # (B, t0, .., t_{d-1})
    if isinstance(program, str):
        program = get_program(program)
    w = program.widths
    d = len(tile)
    spatial = tuple(slice(w[a], None) for a in range(1, d))
    H = halos.clone()
    for s in range(tile[0]):
        # (B, *plane) slices: plane_update keeps leading batch axes whole
        prev = [H[:, w[0] + s - m] for m in range(w[0], 0, -1)]
        plane = program.plane_update(prev, w)
        H[(slice(None), w[0] + s, *spatial)] = plane
    return H[(slice(None), slice(w[0], None), *spatial)]
