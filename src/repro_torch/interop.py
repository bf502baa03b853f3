"""State carried across between the reference package and the port.

numpy only — nothing here imports ``repro``.  A facet dict computed by the
JAX package (``{axis: array}``) moves onto a torch device with
:func:`facets_from_numpy` and back with :func:`facets_to_numpy`; a layout
the JAX autotuner chose (its ``LayoutCandidate`` fields) is rebuilt as the
port's candidate with :func:`candidate_from_key`, so the port runs exactly
that layout (``repro_torch.cfa.compile(..., layout=candidate)``).
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.cfa.autotune import LayoutCandidate

__all__ = ["facets_from_numpy", "facets_to_numpy", "candidate_from_key"]


def facets_from_numpy(
    facets: Mapping[int, np.ndarray], device: "torch.device | str" = "cuda"
) -> dict[int, torch.Tensor]:
    """A facet dict of numpy arrays as tensors on ``device`` (copied)."""
    return {int(k): torch.tensor(np.asarray(v), device=device)
            for k, v in facets.items()}


def facets_to_numpy(facets: Mapping[int, torch.Tensor]) -> dict[int, np.ndarray]:
    """A facet dict of tensors (any device) as host numpy arrays."""
    return {int(k): v.detach().cpu().numpy() for k, v in facets.items()}


def candidate_from_key(
    tile: Sequence[int],
    ext_dirs: "Mapping[int, int] | Sequence[Sequence[int]] | None" = None,
    contiguity: str | None = "intra-tile",
) -> LayoutCandidate:
    """The port's CFA :class:`LayoutCandidate` for a layout given by its
    tile, extension directions and contiguity level (the fields of the
    reference's candidate, e.g. of ``decision.best_cfa().candidate``)."""
    if ext_dirs is not None:
        items = sorted(ext_dirs.items()) if isinstance(ext_dirs, Mapping) else ext_dirs
        ext_dirs = tuple((int(k), int(c)) for k, c in items)
    return LayoutCandidate("cfa", tuple(int(t) for t in tile),
                           ext_dirs=ext_dirs, contiguity=contiguity)
