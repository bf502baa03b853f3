"""The CFA stencil tile executor: CUDA kernel + plain PyTorch version, its
launch plan, and its per-port (multi-port) wrapper."""
from .ref import execute_tiles_ref
from .stencil import LaunchPlan, execute_tiles, launch_plan
from .ops import execute_tiles_sharded, stencil_tile_op

__all__ = ["execute_tiles", "execute_tiles_ref", "execute_tiles_sharded", "stencil_tile_op",
           "launch_plan", "LaunchPlan"]
