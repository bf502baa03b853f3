"""The CFA stencil tile executor: CUDA kernel + plain PyTorch version, and
its per-port (multi-port) wrapper."""
from .ref import execute_tiles_ref
from .stencil import execute_tiles
from .ops import execute_tiles_sharded

__all__ = ["execute_tiles", "execute_tiles_ref", "execute_tiles_sharded"]
