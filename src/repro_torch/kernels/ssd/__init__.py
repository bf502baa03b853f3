"""The Mamba2 SSD chunk scan: CUDA kernel + plain PyTorch versions, and the
one-token decode step."""
from .ops import *  # noqa: F401,F403
from .ops import __all__  # noqa: F401
