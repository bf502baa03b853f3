"""The training loop: a fault-tolerant runner tying together data, steps,
checkpointing and metrics — the port of ``repro/train/loop.py``.

Fault-tolerance contract:
* restart-from-latest: on start, the loop restores the newest committed
  checkpoint and seeks the data stream to its step;
* preemption handling: a sentinel file (``<ckpt_dir>/PREEMPT``) — standing in
  for the cluster's preemption signal — triggers an immediate blocking
  checkpoint and a clean exit;
* periodic async checkpoints overlap disk I/O with compute;
* straggler mitigation: the data pipeline's per-step deadline skips a slow
  batch rather than stalling the step (counted in metrics).

The model is a training model (``init_lm(..., dtype=cfg.param_dtype)``)
drawn from a ``torch.Generator`` seeded with ``seed`` on ``device`` (the
CUDA device unless the caller asks for the CPU).  A checkpoint holds the
model's leaves (``param_leaves``) and the optimizer state, in the
reference's order.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.cfa.api import resolve_device
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import init_lm, param_leaves
from repro_torch.optim import make_optimizer
from repro_torch.train.steps import TrainHParams, make_train_step

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, cfg: ArchConfig, *, batch: int, seq: int,
                 ckpt_dir: str | Path, hp: TrainHParams | None = None,
                 seed: int = 0, ckpt_every: int = 50, data=None, device="cuda"):
        self.cfg = cfg
        self.hp = hp or TrainHParams()
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(ckpt_dir)
        self.ckpt_every = ckpt_every
        self.data = data or SyntheticTokens(vocab=cfg.vocab, batch=batch, seq=seq,
                                            seed=seed)
        opt_init, _ = make_optimizer(cfg.optimizer)
        self.model = init_lm(cfg, generator=torch.Generator(self.device).manual_seed(seed),
                             device=self.device, dtype=cfg.param_dtype)
        self.leaves = param_leaves(self.model)
        self.opt_state = opt_init(self.leaves)
        self.step_fn = make_train_step(cfg, self.hp)
        self.step = 0
        self.metrics_log: list[dict] = []
        self._maybe_restore()

    # ------------------------------------------------------------------

    def state(self) -> list[torch.Tensor]:
        """What a checkpoint holds: the model's leaves, then the optimizer
        state's tensors."""
        return [leaf.value() for leaf in self.leaves] + self.opt_state.tensors()

    def _maybe_restore(self) -> None:
        latest = self.ckpt.latest_step()
        if latest is None:
            return
        restored = self.ckpt.restore(latest, self.state())
        n = len(self.leaves)
        for leaf, value in zip(self.leaves, restored[:n]):
            leaf.assign(value)
        self.opt_state.load(restored[n:])
        self.step = latest
        if hasattr(self.data, "seek"):
            self.data.seek(latest)  # deterministic data: resume exactly

    def _preempted(self) -> bool:
        return (self.ckpt.dir / "PREEMPT").exists()

    # ------------------------------------------------------------------

    def run(self, n_steps: int, *, log_every: int = 10,
            step_deadline_s: float | None = None) -> list[dict]:
        end = self.step + n_steps
        while self.step < end:
            t0 = time.time()
            batch = self.data.next(deadline_s=step_deadline_s)
            batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
            _, self.opt_state, metrics = self.step_fn(self.model, self.opt_state, batch)
            self.step += 1
            if self.step % log_every == 0 or self.step == end:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=self.step, dt=time.time() - t0,
                         skipped_batches=self.data.stats["skipped"])
                self.metrics_log.append(m)
            if self.step % self.ckpt_every == 0:
                self.ckpt.save(self.step, self.state())
            if self._preempted():
                self.ckpt.save(self.step, self.state(), blocking=True)
                break
        self.ckpt.wait()
        return self.metrics_log

    def save_metrics(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.metrics_log, indent=1))
