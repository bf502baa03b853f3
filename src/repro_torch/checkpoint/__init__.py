"""Asynchronous, step-atomic checkpoints."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
