"""The CFA read engine (interior-tile halo fetch): CUDA kernel + plain
PyTorch version."""
from .facet_fetch import fetch_interior_halos
from .ref import fetch_interior_halos_ref

__all__ = ["fetch_interior_halos", "fetch_interior_halos_ref"]
