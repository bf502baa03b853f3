"""Fault-tolerant checkpointing: async, step-atomic, keep-last-k — the port
of ``repro/checkpoint/manager.py``, same protocol and files.

* **step-atomic commit**: a checkpoint is written to ``step_N.tmp/`` and
  renamed to ``step_N/``; a crash mid-write never corrupts the latest one.
* **async**: ``save`` snapshots the tensors to host memory (one
  device-to-host copy each, which waits for the device) and writes them to
  disk on one worker thread, overlapping I/O with the next training steps.
* **keep-last-k GC** bounds disk usage.

A checkpoint is ``leaves.npz`` (``l0``, ``l1``, ... in order) plus
``manifest.json`` (step, time, leaf count, shapes, dtypes), the
reference's schema.  A tree here is a flat list of tensors in a fixed order:
the ``Trainer`` saves the model's leaves (``param_leaves``) and then its
``OptState.tensors()``, the reference's flatten order.  bfloat16 tensors are
stored as float32 (numpy has no bfloat16), which holds them exactly.
Resharding on restore waits for the distribution slice: ``restore`` puts
each leaf on its target's device.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

__all__ = ["CheckpointManager"]


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu")
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


class CheckpointManager:
    def __init__(self, directory: str | Path, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Future | None = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ save

    def save(self, step: int, tree: list[torch.Tensor], *, blocking: bool = False) -> None:
        """Snapshot now, write asynchronously (unless blocking)."""
        host_leaves = [_host(t) for t in tree]
        self.wait()  # one outstanding write at a time
        self._pending = self._pool.submit(self._write, step, host_leaves)
        if blocking:
            self.wait()

    def _write(self, step: int, leaves: list[np.ndarray]) -> None:
        tmp = self.dir / f"step_{step:010d}.tmp"
        final = self.dir / f"step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "leaves.npz", **{f"l{i}": a for i, a in enumerate(leaves)})
        manifest = {
            "step": step,
            "time": time.time(),
            "n_leaves": len(leaves),
            "shapes": [list(a.shape) for a in leaves],
            "dtypes": [str(a.dtype) for a in leaves],
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic commit
        self._gc()

    def _gc(self) -> None:
        with self._lock:
            steps = sorted(self.all_steps())
            for s in steps[: -self.keep]:
                shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    # --------------------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree: list[torch.Tensor]) -> list[torch.Tensor]:
        """The checkpoint's leaves as tensors of ``target_tree``'s dtypes, on
        its devices; raises on a leaf count or shape that does not match."""
        path = self.dir / f"step_{step:010d}"
        data = np.load(path / "leaves.npz")
        if len(target_tree) != len(data.files):
            raise ValueError(
                f"checkpoint has {len(data.files)} leaves, target {len(target_tree)} — "
                "architecture mismatch"
            )
        out = []
        for i, tgt in enumerate(target_tree):
            arr = data[f"l{i}"]
            if tuple(arr.shape) != tuple(tgt.shape):
                raise ValueError(f"leaf {i}: shape {arr.shape} != {tuple(tgt.shape)}")
            out.append(torch.from_numpy(arr).to(device=tgt.device, dtype=tgt.dtype))
        return out
