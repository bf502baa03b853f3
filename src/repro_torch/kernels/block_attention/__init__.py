"""Facet-layout KV-cache decode attention: CUDA kernel + plain PyTorch
version, and the cache's append."""
from .ops import *  # noqa: F401,F403
from .ops import __all__  # noqa: F401
