"""Continuous batching over the facet-layout KV cache (the port of
``repro/serve/scheduler.py``).

The serving loop keeps a fixed number of *lanes* (batch slots).  Each lane
runs its own sequence at its own position — admitted whenever a lane frees
up, retired on max-tokens/EOS — so decode steps always run at full batch
occupancy instead of waiting for the slowest request (the task-level
pipeline of paper Fig. 13, applied to requests).

The facet(block) cache makes lane management cheap: a lane's state is a
batch-row slice of each layer's cache tensors; admission copies one
request's prefilled rows into that lane, without touching other lanes.

One process, one stream, eager PyTorch: admission is host-side control
flow, a decode tick is one ``lm_decode`` over all lanes (the decode
attention kernel runs once per attention layer per tick), and a prefill is
one ``lm_prefill`` per admitted request (the SSD kernel runs once per Mamba
layer).  Spans and counters go to ``recorder``, an ``obs.TraceRecorder``.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.models.lm import LM, init_caches, lm_decode, lm_prefill
from repro_torch.runtime import now

__all__ = ["Request", "ContinuousBatcher"]

_TRACK = "serve/sched"  # single scheduler lane in the trace timeline


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (L,) int
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


def _splice(dst: list[dict], lane: int, src: list[dict]) -> None:
    """Copy a one-request cache (batch row 0) into batch row ``lane``."""
    for d_slot, s_slot in zip(dst, src):
        for key, d in d_slot.items():
            s = s_slot[key]
            for f in dataclasses.fields(d):
                getattr(d, f.name)[lane].copy_(getattr(s, f.name)[0])


class ContinuousBatcher:
    def __init__(self, model: LM, *, lanes: int, max_seq: int, eos: int | None = None,
                 recorder=None):
        self.model = model
        self.cfg = model.cfg
        self.lanes = lanes
        self.max_seq = max_seq
        self.eos = eos
        self.recorder = recorder
        self.queue: deque[Request] = deque()
        self.active: list[Request | None] = [None] * lanes
        self.positions = np.zeros(lanes, np.int64)  # next write index per lane
        self.caches = init_caches(self.cfg, lanes, max_seq, device=model.device)
        self.last_tok = np.zeros(lanes, np.int64)
        self.ticks = 0
        self.tokens = 0
        self._elapsed_s = 0.0

    # ------------------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        rec = self.recorder
        for lane in range(self.lanes):
            if self.active[lane] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            t0 = now() if rec is not None else 0.0
            prompt = torch.as_tensor(np.asarray(req.prompt, np.int64))[None]
            logits, c1 = lm_prefill(self.model, prompt, max_seq=self.max_seq)
            _splice(self.caches, lane, c1)
            tok = int(torch.argmax(logits[0, : self.cfg.vocab]))
            req.out.append(tok)
            self.active[lane] = req
            self.positions[lane] = len(req.prompt)
            self.last_tok[lane] = tok
            if rec is not None:
                rec.add_span("admit", t0, now(), track=_TRACK, cat="serve",
                             rid=req.rid, lane=lane, prompt_len=len(req.prompt))
                rec.counters.add("serve_admitted", 1)
            self._maybe_retire(lane)

    def _retire(self, lane: int) -> None:
        req = self.active[lane]
        req.done = True
        self.active[lane] = None
        rec = self.recorder
        if rec is not None:
            rec.instant("retire", track=_TRACK, cat="serve",
                        rid=req.rid, lane=lane, n_out=len(req.out))
            rec.counters.add("serve_retired", 1)

    def _maybe_retire(self, lane: int) -> None:
        req = self.active[lane]
        if req is None:
            return
        if len(req.out) >= req.max_new or (
                self.eos is not None and req.out and req.out[-1] == self.eos):
            self._retire(lane)

    # ------------------------------------------------------------------

    def step(self) -> int:
        """Admit, run one decode tick over all lanes, retire.  Returns the
        number of active lanes that produced a token."""
        rec = self.recorder
        t0 = now()
        self._admit()
        live = [i for i, r in enumerate(self.active) if r is not None]
        if live:
            logits, self.caches = lm_decode(self.model, self.caches,
                                            torch.as_tensor(self.last_tok),
                                            self.positions.copy())
            toks = torch.argmax(logits[:, : self.cfg.vocab], -1).cpu().numpy()
            for lane in live:
                req = self.active[lane]
                req.out.append(int(toks[lane]))
                self.positions[lane] += 1
                self.last_tok[lane] = toks[lane]
                if self.positions[lane] >= self.max_seq - 1:
                    self._retire(lane)
                else:
                    self._maybe_retire(lane)
        self.ticks += 1
        self.tokens += len(live)
        self._elapsed_s += now() - t0
        if rec is not None:
            rec.add_span("step", t0, now(), track=_TRACK, cat="serve",
                         tick=self.ticks, occupancy=len(live),
                         queue_depth=len(self.queue))
            rec.counter_event("occupancy", len(live))
            rec.counters.add("serve_ticks", 1)
            rec.counters.add("serve_tokens", len(live))
        return len(live)

    def stats(self) -> dict:
        """Tick accounting: decode throughput and current load."""
        return {
            "ticks": self.ticks,
            "tokens": self.tokens,
            "elapsed_s": self._elapsed_s,
            "tokens_per_sec": (self.tokens / self._elapsed_s
                               if self._elapsed_s > 0 else 0.0),
            "occupancy": sum(r is not None for r in self.active) / self.lanes,
            "queue_depth": len(self.queue),
        }

    def run(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self.queue and all(r is None for r in self.active):
                return
            self.step()
        raise RuntimeError("scheduler did not drain")
