"""The CFA stencil tile executor: CUDA kernel + plain PyTorch version."""
from .ref import execute_tiles_ref
from .stencil import execute_tiles

__all__ = ["execute_tiles", "execute_tiles_ref"]
