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

**Sharded trees** (DTensor leaves, every rank of their mesh calling ``save``
with the same steps).  The snapshot gathers each leaf whole on the calling
thread — a collective, so it runs on every rank, in step order, and never
on the writer thread.  Only the mesh's first rank writes; the next
:meth:`CheckpointManager.wait` (or a blocking save) waits for the commit
there and then synchronises the mesh, so no rank reads the directory
before the commit.

**Elastic restore**: the files hold whole arrays, and ``restore`` lays each
leaf out by its entry of ``shardings`` (DTensor placements on the active
mesh, ``use_mesh``; each rank keeps its own slice, with no broadcast), or
by its target's placements where the target is a DTensor and the entry is
None; other leaves go to their target's device.  A checkpoint saved on one
mesh restores onto another bit for bit.
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

from repro_torch.distributed.sharding import full_tensor, get_mesh

__all__ = ["CheckpointManager"]


def _host(t: torch.Tensor) -> np.ndarray:
    t = full_tensor(t.detach()).to("cpu")
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _sync(mesh) -> None:
    """Wait until every rank of ``mesh`` gets here (an all-reduce over each
    mesh dimension, waited for on the host)."""
    import torch.distributed as dist

    flag = torch.zeros(1, device=mesh.device_type)
    for d in range(mesh.ndim):
        dist.all_reduce(flag, group=mesh.get_group(d))
    flag.item()


class CheckpointManager:
    def __init__(self, directory: str | Path, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Future | None = None
        self._mesh = None  # the mesh of a sharded save still to synchronise
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ save

    def save(self, step: int, tree: list[torch.Tensor], *, blocking: bool = False) -> None:
        """Snapshot now, write asynchronously (unless blocking)."""
        host_leaves = [_host(t) for t in tree]  # sharded leaves: gathered here, every rank
        mesh = next((t.device_mesh for t in tree if hasattr(t, "device_mesh")), None)
        self.wait()  # one outstanding write at a time
        if mesh is None or not any(mesh.get_coordinate()):
            self._pending = self._pool.submit(self._write, step, host_leaves)
        self._mesh = mesh
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
        """Wait for the outstanding write; after a sharded save, every rank
        of its mesh waits for the writer's commit."""
        if self._pending is not None:
            self._pending.result()
            self._pending = None
        if self._mesh is not None:
            _sync(self._mesh)
            self._mesh = None

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

    def restore(self, step: int, target_tree: list[torch.Tensor],
                shardings: list | None = None) -> list[torch.Tensor]:
        """The checkpoint's leaves as tensors of ``target_tree``'s dtypes;
        raises on a leaf count or shape that does not match.  ``shardings``
        (optional, one entry per leaf: DTensor placements on the active
        mesh, or None) reshards elastically; a leaf without one takes its
        DTensor target's placements, or its plain target's device."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        path = self.dir / f"step_{step:010d}"
        data = np.load(path / "leaves.npz")
        if len(target_tree) != len(data.files):
            raise ValueError(
                f"checkpoint has {len(data.files)} leaves, target {len(target_tree)} — "
                "architecture mismatch"
            )
        if shardings is None:
            shardings = [None] * len(target_tree)
        elif len(shardings) != len(target_tree):
            raise ValueError(f"{len(shardings)} shardings for {len(target_tree)} leaves")
        mesh = get_mesh()
        out = []
        for i, (tgt, sh) in enumerate(zip(target_tree, shardings)):
            arr = data[f"l{i}"]
            if tuple(arr.shape) != tuple(tgt.shape):
                raise ValueError(f"leaf {i}: shape {arr.shape} != {tuple(tgt.shape)}")
            t = torch.from_numpy(arr).to(dtype=tgt.dtype)
            if sh is not None:
                if mesh is None:
                    raise ValueError("shardings place leaves on the active mesh: "
                                     "restore under use_mesh(mesh)")
                out.append(distribute_tensor(t, mesh, sh, src_data_rank=None))
            elif isinstance(tgt, DTensor):
                out.append(distribute_tensor(t, tgt.device_mesh, tgt.placements,
                                             src_data_rank=None))
            else:
                out.append(t.to(device=tgt.device))
        return out
