"""Where a training step's device time and idle time go among the
program's own spans:

    python3 -m bench.spans --workload <cell> --seed <n> [--cost <pairs>]

from the root of a checkout, on a CUDA device.  It sets the cell's trainer
up as its driver (``bench/drivers/<driver>.py``) does, warms it with the
checked steps and one untraced chunk, then runs ``trace_steps`` steps under
``torch.profiler`` recording the CUDA activity with an ``obs.TraceRecorder``
in the trainer (``Trainer(recorder=...)``), and puts each device operation
and idle gap down to a span (:class:`Attribution`).  The last line of
standard output is one JSON object: by span name the device ms and idle ms
a step, the phase quantities of :func:`phases`, the launch calls outside
every span and the share of kernel time in spans and in the step's phases.
``--cost N`` adds N pairs of profiled windows without and with the
recorder, in alternating order, and their seconds.

A device operation goes, through its correlation id, to the CUDA call that
launched it, then to the innermost span open on the calling thread at that
call, or, where that thread had none open (autograd's device thread outside
a remat recompute), to the trainer thread's innermost span at that moment.
An idle gap between device operations goes to the trainer thread's
innermost span when it began.

This is not a cell of ``BENCHMARK.json``: ``bench.run``'s traced run hands
the trainer no recorder and keeps neither the CUDA calls' threads nor their
correlation ids, so these quantities are not yet per-layer metrics
(``PERF.md`` §7 says which files would change).
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

__all__ = ["Event", "parse", "spans_of", "cupti_tid", "Attribution", "phases", "profile_window",
           "measure", "main"]

#: the step's phases, whose spans hold the device work of a step
PHASES = ("train.forward", "train.backward", "train.clip", "train.optimizer")
OUTSIDE = "(outside spans)"
#: a ``ts`` past this many microseconds (the year 2001 on the Unix clock) is
#: already absolute, whatever base the file gives
_ABSOLUTE_US = 1e15


@dataclasses.dataclass(frozen=True)
class Event:
    kind: str  # "kernel", "copy" (memcpy, memset) or "call" (a CUDA runtime or driver call)
    name: str
    start_us: float
    dur_us: float
    tid: int | None = None  # the host thread of a call
    correlation: int | None = None  # ties a device operation to its launch call


def parse(obj) -> tuple[list, list, float]:
    """(device operations in start order, CUDA calls, base us) of a
    ``torch.profiler`` Chrome trace: each event at its ``ts``, with its
    thread and correlation id, and the Unix microseconds that ``ts`` counts
    from (``baseTimeNanoseconds``; 0 where the file has none or its ``ts``
    are absolute already)."""
    events = obj.get("traceEvents", []) if isinstance(obj, dict) else obj
    base = float(obj.get("baseTimeNanoseconds", 0)) / 1e3 if isinstance(obj, dict) else 0.0
    kinds = {"kernel": "kernel", "gpu_memcpy": "copy", "gpu_memset": "copy",
             "cuda_runtime": "call", "cuda_driver": "call"}
    device, calls = [], []
    for ev in events:
        kind = kinds.get(str(ev.get("cat", "")).lower())
        if ev.get("ph") != "X" or "dur" not in ev or kind is None:
            continue
        corr = (ev.get("args") or {}).get("correlation")
        tid = ev.get("tid")
        e = Event(kind, str(ev.get("name", "")), float(ev["ts"]), float(ev["dur"]),
                  tid=tid if isinstance(tid, int) else None,
                  correlation=int(corr) if corr is not None else None)
        (calls if kind == "call" else device).append(e)
    device.sort(key=lambda e: e.start_us)
    if any(e.start_us > _ABSOLUTE_US for e in calls[:1] + device[:1]):
        base = 0.0
    return device, calls, base


def spans_of(rec, base_us: float, calls: list) -> list:
    """The recorder's training spans as (name, thread id, start us, end us,
    step) on the profiler trace's clock (Unix microseconds less
    ``base_us``).  The thread id is the one the trace's CUDA calls carry:
    the native id, or, where the profiler recorded the CUDA activity alone,
    CUPTI's (:func:`cupti_tid`)."""
    seen = {c.tid for c in calls}
    tids = {tid: tid if tid in seen or cupti_tid(ident) not in seen else cupti_tid(ident)
            for tid, ident in rec.threads.items()}
    train = [s for s in rec.spans if s.cat == "train"]
    steps = [(s.t0, s.t0 + s.dur, s.arg("step")) for s in train if s.name == "train.step"]
    out = []
    for s in train:
        start = rec.unix_us(s.t0) - base_us
        step = next((n for a, b, n in steps if a <= s.t0 <= b), None)
        out.append((s.name, tids[s.tid], start, start + s.dur * 1e6, step))
    return out


def cupti_tid(ident: int) -> int:
    """The ``tid`` a profiler that records the CUDA activity alone writes on
    a CUDA call of the thread whose pthread id is ``ident``: its low 32 bits
    as a signed integer, without the sign."""
    low = ident & 0xFFFFFFFF
    return abs(low - (1 << 32) if low >= 1 << 31 else low)


def busy_intervals(device: list) -> list[tuple[float, float]]:
    """The union of the device operations' intervals, merged, in order."""
    out: list[list[float]] = []
    for e in sorted(device, key=lambda e: e.start_us):
        s, t = e.start_us, e.start_us + e.dur_us
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


class _Timeline:
    """One thread's innermost open span over time, from its spans
    (start, end, index), which nest."""

    def __init__(self, spans: list) -> None:
        # at one instant: the ends of spans that began earlier, then the
        # starts (the longer first, as it encloses), then the ends of spans
        # of no length
        marks = sorted([(s, 1, s - e, i) for s, e, i in spans] +
                       [(e, 0 if e > s else 2, 0, i) for s, e, i in spans])
        self.times: list[float] = []
        self.top: list[int | None] = []
        self.parent: dict[int, int | None] = {}  # each span's enclosing span on this thread
        stack: list[int] = []
        for t, kind, _, i in marks:
            if kind == 1:
                self.parent[i] = stack[-1] if stack else None
                stack.append(i)
            elif stack[-1] == i:
                stack.pop()
            else:
                stack.remove(i)
            self.times.append(t)
            self.top.append(stack[-1] if stack else None)

    def at(self, t: float) -> int | None:
        i = bisect.bisect_right(self.times, t) - 1
        return self.top[i] if i >= 0 else None


@dataclasses.dataclass
class Attribution:
    """Where a window's device time and idle time go among its spans."""

    spans: list
    #: per span, the names from the outermost span down to it; a span opened
    #: with none open on its own thread continues the trainer thread's chain
    #: at its start (a remat recompute's ``moe.dispatch`` lies in
    #: ``train.backward``)
    chains: list
    #: per device operation, the index of the span it was launched in, or None
    device: list
    #: the idle gaps (start us, end us, the trainer thread's innermost span)
    gaps: list
    #: launch calls of device operations that fell outside every span
    launches_outside: int

    @classmethod
    def of(cls, spans: list, calls: list, device: list) -> "Attribution":
        by_tid: dict[int, list] = {}
        for i, (_, tid, start, end, _) in enumerate(spans):
            by_tid.setdefault(tid, []).append((start, end, i))
        lines = {tid: _Timeline(s) for tid, s in by_tid.items()}
        trainer_tid = next((s[1] for s in spans if s[0] == "train.step"), None)
        trainer = lines.get(trainer_tid)
        chains: list = [None] * len(spans)

        def chain(i: int, tid: int) -> tuple:
            if chains[i] is None:
                up = lines[tid].parent[i]
                if up is not None:
                    head = chain(up, tid)
                elif tid != trainer_tid and trainer is not None and \
                        (j := trainer.at(spans[i][2])) is not None:
                    head = chain(j, trainer_tid)
                else:
                    head = ()
                chains[i] = head + (spans[i][0],)
            return chains[i]

        for i, s in enumerate(spans):
            chain(i, s[1])
        by_corr = {c.correlation: c for c in calls if c.correlation is not None}
        put, outside = [], set()
        for e in device:
            call = by_corr.get(e.correlation) if e.correlation is not None else None
            i = None
            if call is not None:
                line = lines.get(call.tid)
                i = line.at(call.start_us) if line is not None else None
                if i is None and trainer is not None:
                    i = trainer.at(call.start_us)
                if i is None:
                    outside.add(e.correlation)
            put.append(i)
        busy = busy_intervals(device)
        gaps = [(e0, s1, trainer.at(e0) if trainer is not None else None)
                for (_, e0), (s1, _) in zip(busy, busy[1:])]
        return cls(spans=spans, chains=chains, device=put, gaps=gaps,
                   launches_outside=len(outside))

    def name(self, i: int | None) -> str:
        return OUTSIDE if i is None else self.spans[i][0]

    def within(self, i: int | None, names) -> bool:
        """The span ``i`` is one of ``names`` or lies inside one."""
        return i is not None and not set(names).isdisjoint(self.chains[i])


def phases(a: Attribution, device: list, steps: int) -> dict:
    """Per step: the device ms launched inside ``train.forward``, inside
    ``train.backward`` (the remat recompute in), inside ``train.clip`` and
    ``train.optimizer``; the idle ms in gaps that began while the trainer
    thread was inside none of the four phases (the feed, the copy, the
    log, a checkpoint, the preemption check, or between them); the device
    ms launched with ``moe.dispatch`` or ``moe.combine`` innermost (their
    self time; None without them).  Beside them, by span name the device ms
    (innermost) and idle ms a step, the launch calls outside every span and
    the shares of kernel time in spans and in the phases."""
    def ms(pick) -> float:
        return sum(e.dur_us for e, i in zip(device, a.device) if pick(i)) / 1e3 / steps

    moe = {"moe.dispatch", "moe.combine"}
    table: dict[str, list[float]] = {}
    for e, i in zip(device, a.device):
        table.setdefault(a.name(i), [0.0, 0.0])[0] += e.dur_us / 1e3 / steps
    for s, t, i in a.gaps:
        table.setdefault(a.name(i), [0.0, 0.0])[1] += (t - s) / 1e3 / steps
    kernels = [(e.dur_us, i) for e, i in zip(device, a.device) if e.kind == "kernel"]
    total = sum(us for us, _ in kernels) or 1.0
    return {
        "forward_ms_per_step": ms(lambda i: a.within(i, {"train.forward"})),
        "backward_ms_per_step": ms(lambda i: a.within(i, {"train.backward"})),
        "optimizer_ms_per_step": ms(lambda i: a.within(i, {"train.clip", "train.optimizer"})),
        "trainer_idle_ms_per_step": sum(t - s for s, t, i in a.gaps
                                        if not a.within(i, PHASES)) / 1e3 / steps,
        "moe_dispatch_ms_per_step": ms(lambda i: a.name(i) in moe)
        if any(s[0] in moe for s in a.spans) else None,
        "ms_per_step": {k: {"device_ms": v[0], "idle_ms": v[1]}
                        for k, v in sorted(table.items(), key=lambda kv: -sum(kv[1]))},
        "launches_outside_spans": a.launches_outside,
        "kernel_pct_in_spans": 100.0 * sum(us for us, i in kernels if i is not None) / total,
        "kernel_pct_in_phases": 100.0 * sum(us for us, i in kernels
                                            if a.within(i, PHASES)) / total,
    }


def profile_window(trainer, steps: int, recorder, device) -> tuple[dict, float]:
    """Run ``steps`` steps under ``torch.profiler`` (the CUDA activity on a
    CUDA device, else the CPU's) with ``recorder`` in the trainer (None:
    none); return the Chrome trace and the window's seconds, synchronize to
    synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        sync()
        t0 = time.perf_counter()
        trainer.recorder = recorder
        try:
            trainer.run(steps, log_every=steps)
        finally:
            trainer.recorder = None
        sync()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f), window_s
    finally:
        os.unlink(path)


def measure(config: dict, mix: dict, seed: int, device, cost: int = 0) -> dict:
    """Set the cell's trainer up, warm it, profile one window with a
    recorder and attribute it; then ``cost`` pairs of windows without and
    with a recorder."""
    from bench import registry
    from repro_torch.core.cfa import obs

    drv = registry.driver(mix["driver"])
    ckpt_dir = tempfile.mkdtemp(prefix="bench-spans-")
    try:
        trainer = drv.make_trainer(config, mix, seed, device, ckpt_dir)
        try:
            drv.program_readings(trainer, config, mix, seed)
            trainer.run(mix["chunk_steps"], log_every=mix["chunk_steps"])
            n = mix["trace_steps"]
            rec = obs.TraceRecorder(label="bench.spans")
            obj, window_s = profile_window(trainer, n, rec, device)
            device_ops, calls, base = parse(obj)
            spans = spans_of(rec, base, calls)
            out = {"steps": n, "window_s": window_s, "spans": len(spans),
                   **phases(Attribution.of(spans, calls, device_ops), device_ops, n)}
            del obj, device_ops, calls
            windows = []
            for k in range(2 * cost):
                on = (k % 2 == 1) == (k // 2 % 2 == 0)  # off, on, on, off, ...
                _, s = profile_window(trainer, n, obs.TraceRecorder() if on else None, device)
                windows.append(["recorder" if on else "none", s])
            out["cost_windows_s"] = windows
            return out
        finally:
            trainer.data.close()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m bench.spans", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--cost", type=int, default=0,
                   help="pairs of profiled windows without and with the recorder")
    args = p.parse_args(argv)
    for path in (str(ROOT / "src"), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)
    from bench import registry

    cell = registry.workload(args.workload)
    config, mix = registry.config(cell["config"]), registry.traffic(cell["traffic"])
    import torch

    if not torch.cuda.is_available():
        print("bench.spans: needs a CUDA device", file=sys.stderr)
        return 2
    out = measure(config, mix, args.seed, "cuda", args.cost)
    out = {"workload": cell["name"], "seed": args.seed, "device": torch.cuda.get_device_name(0),
           **out}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
