"""Synthetic token pipeline with sequence packing and host->device prefetch
(a numpy copy of ``repro/data/pipeline.py``: the same seeds give the same
batches).

The host side mirrors the paper's read stage: batches are assembled in
device-tile-major order so each device's shard is one contiguous extent
(a single "burst" per device per step — CFA's full-tile contiguity applied
to the input pipeline), and a background thread keeps ``prefetch`` batches
in flight so the accelerator never waits on the host (the paper's
read/execute overlap).

Straggler mitigation: ``next`` takes a deadline; a batch that misses it is
skipped and counted (at cluster scale: the slow host's shard is replaced by
the backup stream; here: emulated and surfaced in ``stats``).
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np

__all__ = ["SyntheticTokens", "PackedDocs"]


class SyntheticTokens:
    """Deterministic, seekable synthetic LM batches (tokens only)."""

    def __init__(self, *, vocab: int, batch: int, seq: int, seed: int = 0,
                 prefetch: int = 2):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed = seed
        self.step = 0
        self._lock = threading.Lock()
        self._next = 0
        self._gen = 0
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self.stats = {"skipped": 0, "produced": 0}
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        return {
            "tokens": rng.integers(0, self.vocab, size=(self.batch, self.seq),
                                   dtype=np.int32)
        }

    def _producer(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                gen, step = self._gen, self._next
                self._next += 1
            b = self.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((gen, step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            self.stats["produced"] += 1

    def seek(self, step: int) -> None:
        """Restart the stream at ``step`` (deterministic resume after a
        checkpoint restore); stale prefetched batches are discarded."""
        with self._lock:
            self._gen += 1
            self._next = step
        self.step = step

    def next(self, deadline_s: float | None = None) -> dict:
        """Next batch; on deadline miss, skip ahead (straggler mitigation)."""
        while True:
            try:
                gen, step, b = self._q.get(
                    timeout=deadline_s if deadline_s else 300.0)
            except queue.Empty:
                self.stats["skipped"] += 1
                b = self.batch_at(self.step)  # deterministic fallback
                step = self.step
                break
            if gen == self._gen:
                break  # else: stale pre-seek batch, discard
        self.step = step + 1
        return b

    def close(self) -> None:
        self._stop.set()


class PackedDocs(SyntheticTokens):
    """Documents of random length packed into fixed-length rows with EOS
    separators — contiguous packing, no padding waste."""

    def __init__(self, *, vocab: int, batch: int, seq: int, seed: int = 0,
                 mean_doc_len: int = 512, eos: int = 0, prefetch: int = 2):
        self.mean_doc_len = mean_doc_len
        self.eos = eos
        super().__init__(vocab=vocab, batch=batch, seq=seq, seed=seed,
                         prefetch=prefetch)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step, 7))
        rows = np.empty((self.batch, self.seq), dtype=np.int32)
        for r in range(self.batch):
            fill = 0
            while fill < self.seq:
                n = int(rng.geometric(1.0 / self.mean_doc_len))
                n = min(max(n, 2), self.seq - fill)
                rows[r, fill : fill + n] = rng.integers(
                    1, self.vocab, size=n, dtype=np.int32)
                rows[r, fill + n - 1] = self.eos
                fill += n
        return {"tokens": rows}
