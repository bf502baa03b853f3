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

With ``mesh`` (a ``DeviceMesh`` over every rank, each rank running the same
``Trainer``), every rank draws the same full weights, ``shard_lm`` places
them and the optimizer makes its moments with the placements of
``opt_state_specs``; the data pipeline yields the global batch, which the
step slices, and the loop runs under ``use_mesh(mesh)``.  Checkpoints are
gathered whole and written by rank 0 (``CheckpointManager``), a restart
restores them onto the current mesh's placements, and a preemption seen by
any rank stops every rank after the same step.

With ``recorder`` (an ``obs.TraceRecorder``), :meth:`Trainer.run` installs
it for its duration and records ``train.step`` (args ``step``) with the
children ``train.feed`` (the wait on the data pipeline), ``train.to_device``,
``train.log`` (a log step's synchronizing reads), ``train.checkpoint`` and
``train.preempt``; the step's own spans (``train/steps.py``) and the MoE's
(``models/moe.py``) nest inside.  Without one a span site costs one ``is
None`` check.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from repro_torch import runtime
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.distributed.sharding import use_mesh
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import init_lm, param_leaves, shard_lm
from repro_torch.optim import make_optimizer
from repro_torch.runtime import resolve_device
from repro_torch.train.steps import TrainHParams, make_train_step

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, cfg: ArchConfig, *, batch: int, seq: int,
                 ckpt_dir: str | Path, hp: TrainHParams | None = None,
                 mesh=None, seed: int = 0, ckpt_every: int = 50, data=None, device="cuda",
                 recorder=None):
        self.cfg = cfg
        self.recorder = recorder
        self.hp = hp or TrainHParams()
        self.mesh = mesh
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(ckpt_dir)
        self.ckpt_every = ckpt_every
        self.data = data or SyntheticTokens(vocab=cfg.vocab, batch=batch, seq=seq,
                                            seed=seed)
        opt_init, _ = make_optimizer(cfg.optimizer)
        self.model = init_lm(cfg, generator=torch.Generator(self.device).manual_seed(seed),
                             device=self.device, dtype=cfg.param_dtype)
        if mesh is not None:
            shard_lm(self.model, mesh)
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

    def shardings(self) -> list:
        """The placements of every tensor of :meth:`state` (None for plain
        tensors): the current mesh's, for a restore."""
        return [getattr(t, "placements", None) for t in self.state()]

    def _maybe_restore(self) -> None:
        latest = self.ckpt.latest_step()
        if latest is None:
            return
        with use_mesh(self.mesh):
            restored = self.ckpt.restore(latest, self.state(), shardings=self.shardings())
        n = len(self.leaves)
        for leaf, value in zip(self.leaves, restored[:n]):
            leaf.assign(value)
        self.opt_state.load(restored[n:])
        self.step = latest
        if hasattr(self.data, "seek"):
            self.data.seek(latest)  # deterministic data: resume exactly

    def _preempted(self) -> bool:
        """The sentinel file exists (on a mesh: as seen by any rank)."""
        seen = (self.ckpt.dir / "PREEMPT").exists()
        if self.mesh is None:
            return seen
        import torch.distributed as dist

        flag = torch.tensor(float(seen), device=self.device)
        for d in range(self.mesh.ndim):
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.mesh.get_group(d))
        return bool(flag)

    # ------------------------------------------------------------------

    def run(self, n_steps: int, *, log_every: int = 10,
            step_deadline_s: float | None = None) -> list[dict]:
        """Train ``n_steps`` more steps (fewer if preempted); every
        ``log_every`` steps and at the last, append the step's metrics to
        ``metrics_log`` with ``dt``: the seconds per step since the previous
        log of this call (since the call began, for its first), read after
        the log's own reads, which wait for the device."""
        rec = self.recorder
        with use_mesh(self.mesh), (runtime.NO_SPAN if rec is None else rec.installed()):
            end = self.step + n_steps
            t_log, step_log = time.perf_counter(), self.step
            while self.step < end:
                if rec is not None:
                    rec.mark_clock()
                with runtime.train_span(rec, "train.step", step=self.step + 1):
                    with runtime.train_span(rec, "train.feed"):
                        batch = self.data.next(deadline_s=step_deadline_s)
                    with runtime.train_span(rec, "train.to_device"):
                        batch = {k: torch.as_tensor(v, device=self.device)
                                 for k, v in batch.items()}
                    _, self.opt_state, metrics = self.step_fn(self.model, self.opt_state, batch)
                    self.step += 1
                    if self.step % log_every == 0 or self.step == end:
                        with runtime.train_span(rec, "train.log"):
                            m = {k: float(v) for k, v in metrics.items()}
                        t = time.perf_counter()
                        m.update(step=self.step, dt=(t - t_log) / (self.step - step_log),
                                 skipped_batches=self.data.stats["skipped"])
                        self.metrics_log.append(m)
                        t_log, step_log = t, self.step
                    if self.step % self.ckpt_every == 0:
                        with runtime.train_span(rec, "train.checkpoint"):
                            self.ckpt.save(self.step, self.state())
                    with runtime.train_span(rec, "train.preempt"):
                        if self._preempted():
                            self.ckpt.save(self.step, self.state(), blocking=True)
                            break
            self.ckpt.wait()
        return self.metrics_log

    def save_metrics(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.metrics_log, indent=1))
