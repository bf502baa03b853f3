"""What every layer of the port shares — the device check, the clock and
the recorder the training span sites write to — in a leaf module that
imports only PyTorch and the standard library."""
from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["resolve_device", "now", "install", "active", "train_span", "NO_SPAN"]


def resolve_device(device: "torch.device | str") -> torch.device:
    """The torch device to compile for; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA device, but "
            f"torch.cuda.is_available() is False here; pass device='cpu' to "
            f"run on the CPU (the kernels then run their plain PyTorch "
            f"versions)"
        )
    return dev


#: the one wall-clock every timed path in the port reads
now = time.perf_counter

#: the installed recorder (an ``obs.TraceRecorder``; None: tracing off).  A
#: module global, not a context variable: autograd runs a remat recompute
#: (``moe``'s spans) on its own thread, which inherits no context.
_ACTIVE = None

#: what a span site enters when no recorder is installed (nothing allocated)
NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def install(rec):
    """Make ``rec`` the recorder :func:`active` returns, in every thread,
    until the block ends (the one before it again after)."""
    global _ACTIVE
    before, _ACTIVE = _ACTIVE, rec
    try:
        yield rec
    finally:
        _ACTIVE = before


def active():
    """The recorder :func:`install` installed, or None."""
    return _ACTIVE


def train_span(rec, name: str, step: int | None = None):
    """``rec``'s span ``name`` on the ``train`` track (``step`` in its
    args when given), or :data:`NO_SPAN` when ``rec`` is None."""
    if rec is None:
        return NO_SPAN
    if step is None:
        return rec.span(name, track="train", cat="train")
    return rec.span(name, track="train", cat="train", step=step)
