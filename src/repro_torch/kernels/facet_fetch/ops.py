"""The read engine over port-resident facets: TPU kernel 2s.

Replaces the reference package's ``repro/kernels/facet_fetch/ops.py::
fetch_interior_halos_sharded``: the facet tensors are placed on their
assigned ports (``repro_torch.distributed.sharding.shard_facets``), each is
pulled into the fetch engine's device with one explicit transfer per facet
that lies elsewhere, and the hand-written read engine (``csrc/facet_fetch.cu``,
through :func:`~repro_torch.kernels.facet_fetch.fetch_interior_halos`) runs
once over them.  On one card every port shares the device, so placement
and transfer are the identity — as in the reference for facets already
resident on their port — and the work is kernel 2's, bounded by memory
like it.  ``fetch_interior_halos_sharded.launches`` counts its kernel
launches (one per call on a CUDA device; the plain path does not count).
"""
from __future__ import annotations

import torch

from .facet_fetch import fetch_interior_halos
from .ref import fetch_interior_halos_ref

__all__ = ["fetch_interior_halos", "fetch_interior_halos_ref",
           "fetch_interior_halos_sharded"]


def fetch_interior_halos_sharded(program_name: str, facets: dict, space, tile,
                                 assignment, mesh=None, *,
                                 storage: str = "redundant") -> torch.Tensor:
    """Block-wise halo fetch with the facet tensors resident on their ports.

    ``assignment`` is a ``multiport.PortAssignment``; ``mesh`` a
    :class:`~repro_torch.distributed.sharding.PortMesh` (default: its
    ``n_ports`` ports on the facets' device).  Returns the same
    (n0-1, n1-1, n2-1, w0+t0, w1+t1, w2+t2) halo volume as
    :func:`fetch_interior_halos`.
    """
    from repro_torch.distributed.sharding import port_mesh, shard_facets

    if mesh is None:
        mesh = port_mesh(assignment.n_ports, facets[0].device)
    facets = shard_facets(facets, assignment.facet_to_port, mesh)
    # one transfer per facet into the engine's device, skipped for facets
    # already resident there (every port of a one-device mesh)
    engine = mesh.port_device(0)
    facets = {k: v if v.device == engine else v.to(engine) for k, v in facets.items()}
    out = fetch_interior_halos(program_name, facets, tuple(space), tuple(tile),
                               storage=storage)
    if out.device.type == "cuda":
        fetch_interior_halos_sharded.launches += 1
    return out


#: kernel launches since the last reset (set to 0 to reset)
fetch_interior_halos_sharded.launches = 0
