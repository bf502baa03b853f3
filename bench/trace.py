"""What a traced run hands the per-layer metric readers: the device
operations of one profiled window (``torch.profiler`` recording the CUDA
activity, read from its Chrome trace), the CUDA runtime calls beside them,
the window's facts (steps, length, shapes, peak memory) and the host-clock
length of the chunks of steps run just before it without the profiler.

A reader (``bench/metrics/<metric>.py``) takes a :class:`Trace` and returns
a number, or None where the trace holds nothing for it.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re
import tempfile
from pathlib import Path

__all__ = ["Trace", "Op", "read_chrome_trace", "kernel_class", "short_name"]

_CLASSES = json.loads((Path(__file__).parent / "counts" / "kernel_classes.json").read_text())


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    start_us: float
    dur_us: float


@dataclasses.dataclass
class Trace:
    kind: str  # the kind of work of the driver that made it ("train")
    kernels: list  # device kernels (Op), in start order
    device_ops: list  # kernels, copies and fills on the device (Op)
    host_ops: list  # CUDA runtime and driver calls (Op)
    steps: int  # steps of work in the window
    window_s: float  # host clock from the synchronize before to the one after
    plain_steps: int  # steps of the chunks run just before, without the profiler
    plain_s: float  # their host clock, synchronize to synchronize
    arch: dict  # the configuration's ``arch``
    batch: int
    seq: int
    peak_bytes: int  # max_memory_allocated over the window

    def busy_s(self) -> float:
        """Seconds in which some device operation ran: the union of their
        intervals (merged, not summed)."""
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        out: list[list[float]] = []
        for op in sorted(self.device_ops, key=lambda o: o.start_us):
            s, e = op.start_us, op.start_us + op.dur_us
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def class_us(self, cls: str) -> float:
        return sum(k.dur_us for k in self.kernels if kernel_class(k.name) == cls)

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time, and the idle time
        between device operations by the CUDA call that was running when
        each gap began (the innermost one); a gap that began outside any
        is the host's own work (Python, operator dispatch)."""
        by_name: dict[str, float] = {}
        for op in self.device_ops:
            key = short_name(op.name)
            by_name[key] = by_name.get(key, 0.0) + op.dur_us / 1e6
        busy = self.busy_intervals()
        host = sorted(self.host_ops, key=lambda o: o.start_us)
        starts = [o.start_us for o in host]
        gaps: dict[str, float] = {}
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            label = "(host, outside CUDA calls)"
            i = bisect.bisect_right(starts, e0)
            best = None
            # the innermost op covering the gap's start: the latest-starting of
            # the ops begun before it (host ops nest, so it began recently)
            for op in reversed(host[max(0, i - 400):i]):
                if op.start_us + op.dur_us >= e0 and (best is None or op.start_us > best.start_us):
                    best = op
            if best is not None:
                label = short_name(best.name)
            gaps[label] = gaps.get(label, 0.0) + (s1 - e0) / 1e6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]  # noqa: E731
        return {"device_ops": top(by_name), "idle_gaps": top(gaps)}


def short_name(name: str) -> str:
    """A kernel or operator name without its return type, namespaces'
    noise, template arguments and parameter list, at most 80 characters."""
    s = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    s = s.split("(", 1)[0]
    depth, out = 0, []
    for ch in s:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    return "".join(out)[:80] or name[:80]


def kernel_class(name: str) -> str:
    """``port``, ``gemm``, ``elementwise`` or ``other`` by the frozen table."""
    for cls, pattern in _CLASSES["classes"]:
        if re.search(pattern, name):
            return cls
    return "other"


def read_chrome_trace(prof) -> tuple[list, list, list]:
    """(kernels, device ops, host ops) of a finished ``torch.profiler``
    window, through a Chrome trace written to ``$TMPDIR`` and removed."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    kernels, device, host = [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = str(ev.get("cat", "")).lower()
        op = Op(str(ev.get("name", "")), float(ev["ts"]), float(ev["dur"]))
        if cat == "kernel":
            kernels.append(op)
            device.append(op)
        elif cat in ("gpu_memcpy", "gpu_memset"):
            device.append(op)
        elif cat in ("cuda_runtime", "cuda_driver"):
            host.append(op)
    kernels.sort(key=lambda o: o.start_us)
    return kernels, device, host
