"""Training data: seekable synthetic token batches (numpy)."""
from .pipeline import PackedDocs, SyntheticTokens

__all__ = ["SyntheticTokens", "PackedDocs"]
