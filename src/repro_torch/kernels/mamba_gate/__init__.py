"""The Mamba2 block's epilogue (D skip, SiLU gate, RMSNorm): CUDA kernel,
forward and backward, and its plain PyTorch version."""
from .ops import *  # noqa: F401,F403
from .ops import __all__  # noqa: F401
