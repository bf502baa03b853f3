"""The CFA read engine (interior-tile halo fetch): CUDA kernel + plain
PyTorch version, and its port-resident (multi-port) wrapper."""
from .facet_fetch import fetch_interior_halos
from .ref import fetch_interior_halos_ref
from .ops import fetch_interior_halos_sharded

__all__ = ["fetch_interior_halos", "fetch_interior_halos_ref",
           "fetch_interior_halos_sharded"]
