"""Runtime burst telemetry: span tracing, counters, attribution.

The paper's thesis is that effective memory bandwidth bounds the
accelerator, and the Memory Controller Wall study (Zohouri & Matsuoka
2019) shows real memory interfaces drifting far from analytic models —
yet until this module the repo could only *model* transfers
(:class:`BurstModel`, the CFA3xx lint) or time them in aggregate
(``calibrate``).  ``obs`` turns every execution into an inspectable,
attributable timeline:

* :class:`Span` / :class:`TraceRecorder` — structured spans
  (``copy_in`` / ``execute_tile`` / ``copy_out`` / ``halo_resolve`` per
  tile, grouped by wave and port, with facet/burst accounting linking
  back to the tile's :class:`TransferPlan`) emitted by every
  ``CFAPipeline._sweep*`` executor; the ``dataflow`` executor's
  overlapped prefetch/compute/commit appear as concurrent per-port lanes.
* :class:`Counters` — a deterministic metrics registry (bursts issued,
  wire vs stored bytes, tiles, waves, halo indirections) whose totals
  :meth:`TraceRecorder.reconcile` checks *exactly* against
  ``BurstModel.plan_bytes`` and the per-tile plans' read/write
  accounting — the runtime counterpart of the CFA1xx static verifier.
* Chrome trace-event JSON (:meth:`TraceRecorder.to_chrome`,
  Perfetto-loadable; the reference package has the ``tools/cfa_trace.py`` CLI) with the
  compile-time :class:`PassTrace` stages folded into the same timeline.
* The shared measurement clock: :func:`now`, :func:`burn`,
  :func:`measure_defaults` (``REPRO_MEASURE_WARMUP`` /
  ``REPRO_MEASURE_REPEATS``) and the host noise probe
  (:func:`timing_unusable_reason` / :func:`measurement_noise`,
  ``REPRO_TIMING_TESTS``) — one home for every wall-clock fidelity knob;
  ``calibrate.measure_runs`` / ``measure_plan`` emit their timed passes
  as spans through the same recorder.
* :class:`RuntimeReport` / :func:`runtime_report` — measured-vs-modeled
  attribution: per-facet / per-port observed time against
  ``BurstModel.time``, worst offender first, each row carrying the same
  fixit vocabulary (:data:`~repro_torch.core.cfa.analysis.FIXIT_KNOBS`) as the
  static analysis diagnostics.

Tracing is strictly opt-in: with no recorder attached the executors pay
one ``is None`` check per phase — no recorder, span or context-manager
allocation on the hot path.

Spans are host-clock spans.  On a CUDA device PyTorch returns before the
device finishes, so a span around a phase times its *enqueue*, not the
device work; only a span that ends in ``torch.cuda.synchronize()`` (or
CUDA-event timing, which ``chip_smoke.py`` uses for the kernels) measures
the card.  The counters are exact either way.  The measurement harness
(``measure_runs``/``measure_plan``) and the measured attribution
(:func:`runtime_report`) arrive with the port's calibration slice.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import time
from pathlib import Path
from typing import Any, Iterable, Mapping

__all__ = [
    "Span",
    "Counters",
    "TraceRecorder",
    "RuntimeReport",
    "runtime_report",
    "chrome_trace",
    "validate_chrome_trace",
    "now",
    "burn",
    "measure_defaults",
    "timing_unusable_reason",
    "measurement_noise",
]


# --------------------------------------------------------------------------
# The shared clock + measurement fidelity knobs
# --------------------------------------------------------------------------

#: the one wall-clock every timed path in the repo reads (``calibrate``'s
#: measurement passes, ``passes.PassPipeline`` stage timing, the serving
#: scheduler's tick accounting, and every recorded span)
now = time.perf_counter

_DEF_WARMUP = 1
_DEF_REPEATS = 5


def measure_defaults(warmup: int | None, repeats: int | None) -> tuple[int, int]:
    """Resolve warmup/median-of-k, honouring the env-var escape hatches
    ``REPRO_MEASURE_WARMUP`` / ``REPRO_MEASURE_REPEATS``."""
    if warmup is None:
        warmup = int(os.environ.get("REPRO_MEASURE_WARMUP", _DEF_WARMUP))
    if repeats is None:
        repeats = int(os.environ.get("REPRO_MEASURE_REPEATS", _DEF_REPEATS))
    if warmup < 0:
        raise ValueError(f"warmup must be >= 0: {warmup}")
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1: {repeats}")
    return warmup, repeats


def burn(seconds: float) -> None:
    """Occupy ``seconds`` of wall-clock — the stand-in for tile compute.

    Models a *dedicated* compute engine (Fig. 13 DATAFLOW: compute does
    not contend with the DMA engine): the bulk is slept, so the host cores
    stay free for in-flight copy threads, and only a short tail is spun
    for timer precision.  Either way the time cannot be elided by the
    device queue."""
    if seconds <= 0.0:
        return
    end = now() + seconds
    while (remaining := end - now()) > 0.0:
        if remaining > 5e-4:
            time.sleep(remaining - 2e-4)


# --------------------------------------------------------------------------
# Noise probe (the skip-with-reason hook behind the timing tests)
# --------------------------------------------------------------------------

_PROBE_SCHEDULE = (4096,) * 8
_MAX_NOISE = 0.75  # relative spread beyond which timing tests must skip


@functools.lru_cache(maxsize=1)
def _timing_probe() -> tuple[str | None, float]:
    """(why timing is unusable here | None, measured relative noise).

    Probe once, cache, let tests skip with the reason.
    ``REPRO_TIMING_TESTS=skip`` forces the skip (CI escape hatch for
    known-noisy runners); ``=force`` trusts the host unconditionally.
    """
    override = os.environ.get("REPRO_TIMING_TESTS", "").strip().lower()
    if override in ("force", "run", "1"):
        return None, 0.0
    if override in ("skip", "0"):
        return "REPRO_TIMING_TESTS=skip set in the environment", 1.0
    res = time.get_clock_info("perf_counter").resolution
    if res > 1e-4:
        return f"perf_counter resolution too coarse ({res:.1e} s)", 1.0
    try:
        from .calibrate import measure_runs  # lazy: calibrate imports obs
    except ImportError:
        return ("no measurement harness in this package yet (it arrives "
                "with the calibration slice)"), 1.0
    try:
        ts = [measure_runs(_PROBE_SCHEDULE, 8, warmup=1, repeats=3)
              for _ in range(2)]
    except Exception as e:  # no usable device, OOM, ...
        return f"measurement harness failed to run ({e!r})", 1.0
    lo = min(ts)
    if lo <= 0.0:
        return "reference schedule measured as zero time", 1.0
    spread = (max(ts) - lo) / lo
    if spread > _MAX_NOISE:
        return (f"host timing too noisy (reference schedule spread "
                f"{spread:.0%} > {_MAX_NOISE:.0%})"), spread
    return None, spread


def timing_unusable_reason() -> str | None:
    """None when wall-clock measurement is trustworthy here, else why not."""
    return _timing_probe()[0]


def measurement_noise() -> float:
    """Relative spread of the reference schedule on this host (probe-
    cached); timing tests scale their tolerances by it."""
    return _timing_probe()[1]


# --------------------------------------------------------------------------
# Spans + counters
# --------------------------------------------------------------------------

#: span categories (the Chrome trace event ``cat`` field)
SPAN_CATS = ("compile", "runtime", "measure", "serve")


@dataclasses.dataclass(frozen=True)
class Span:
    """One timed interval on the trace: a phase of one tile, a lowering
    pass, a measurement pass, or a scheduler tick.

    ``track`` names the lane the span renders on (``port0/fetch``,
    ``port0/compute``, ``port0/commit``, ``compile``, ``measure``,
    ``serve/step``, ...) — concurrent lanes are how the dataflow
    executor's overlap becomes visible.  ``t0`` is seconds since the
    recorder's epoch; compile spans folded from :class:`PassTrace`
    records sit on the negative side of the epoch.  ``args`` carries the
    structured payload (tile, wave, port, facet ids, burst/byte
    accounting from the tile's :class:`TransferPlan`).
    """

    name: str
    cat: str
    track: str
    t0: float
    dur: float
    args: tuple[tuple[str, Any], ...] = ()

    def __post_init__(self) -> None:
        if self.cat not in SPAN_CATS:
            raise ValueError(f"cat must be one of {SPAN_CATS}: {self.cat!r}")
        if not (self.dur >= 0.0 and math.isfinite(self.dur)):
            raise ValueError(f"dur must be finite and >= 0: {self.dur}")

    def arg(self, key: str, default: Any = None) -> Any:
        return dict(self.args).get(key, default)

    def to_dict(self) -> dict:
        return {"name": self.name, "cat": self.cat, "track": self.track,
                "t0": self.t0, "dur": self.dur, "args": dict(self.args)}


class Counters:
    """A deterministic metrics registry: name -> numeric total.

    Totals are exact by construction (integer tile/burst/element counts;
    byte figures from ``BurstModel.burst_bytes`` sums), which is what lets
    :meth:`TraceRecorder.reconcile` compare them *equal*, not close, to
    the plan accounting."""

    def __init__(self) -> None:
        self._vals: dict[str, float] = {}

    def add(self, name: str, value: float = 1) -> None:
        self._vals[name] = self._vals.get(name, 0) + value

    def get(self, name: str, default: float = 0) -> float:
        return self._vals.get(name, default)

    def __getitem__(self, name: str) -> float:
        return self._vals[name]

    def __contains__(self, name: str) -> bool:
        return name in self._vals

    def as_dict(self) -> dict[str, float]:
        return dict(sorted(self._vals.items()))

    def __repr__(self) -> str:
        return f"Counters({self.as_dict()})"


class TraceRecorder:
    """Collects spans, counters and counter-sample events for one run.

    Attach one to a :class:`~repro_torch.core.cfa.transform.CFAPipeline` (the
    ``recorder`` field) and every executor phase records itself; or pass
    one to ``calibrate.measure_runs`` / ``ContinuousBatcher`` for the
    measurement and serving paths.  ``cfa.compile(..., trace=True)``
    wires all of this up and surfaces the recorder as
    ``CompiledStencil.last_trace()``.

    ``model`` (a :class:`BurstModel`) prices the byte counters; without
    one the recorder still collects spans and structural counters but no
    wire-byte totals.  ``port`` is the current lane group — the sharded
    executor sets it per tile so spans land on ``port{n}/...`` tracks.
    """

    def __init__(self, model=None, label: str = "") -> None:
        self.model = model
        self.label = label
        self.epoch = now()
        self.port = 0
        self.spans: list[Span] = []
        self.counters = Counters()
        self.counter_samples: list[tuple[float, str, float]] = []
        self.meta: dict[str, Any] = {}
        self._open: dict[int, tuple[str, str, str, float, tuple]] = {}
        self._next_token = 0
        self._plan_cache: dict[tuple[int, ...], Any] = {}

    # -- clock ------------------------------------------------------------

    def now(self) -> float:
        return now()

    def track(self, phase: str) -> str:
        """The current port's lane for ``phase`` (fetch/compute/commit)."""
        return f"port{self.port}/{phase}"

    # -- span emission ----------------------------------------------------

    def add_span(self, name: str, t0: float, t1: float, *, track: str,
                 cat: str = "runtime", **args: Any) -> Span:
        """Record a closed interval [t0, t1] (absolute clock readings)."""
        span = Span(name=name, cat=cat, track=track, t0=t0 - self.epoch,
                    dur=max(0.0, t1 - t0), args=tuple(args.items()))
        self.spans.append(span)
        return span

    def begin(self, name: str, *, track: str, cat: str = "runtime",
              **args: Any) -> int:
        """Open a span now; close it with :meth:`end`.  Open/close pairs
        are how the dataflow executor brackets a tile's in-flight compute
        (dispatch -> commit) across loop iterations."""
        token = self._next_token
        self._next_token += 1
        self._open[token] = (name, track, cat, now(), tuple(args.items()))
        return token

    def end(self, token: int) -> Span:
        name, track, cat, t0, args = self._open.pop(token)
        span = Span(name=name, cat=cat, track=track, t0=t0 - self.epoch,
                    dur=max(0.0, now() - t0), args=args)
        self.spans.append(span)
        return span

    @contextlib.contextmanager
    def span(self, name: str, *, track: str, cat: str = "runtime",
             **args: Any):
        token = self.begin(name, track=track, cat=cat, **args)
        try:
            yield
        finally:
            self.end(token)

    def instant(self, name: str, *, track: str, cat: str = "runtime",
                **args: Any) -> Span:
        t = now()
        return self.add_span(name, t, t, track=track, cat=cat, **args)

    def counter_event(self, name: str, value: float) -> None:
        """A time-stamped counter sample (occupancy, queue depth, ...);
        exported as a Chrome ``"C"`` event so Perfetto plots it."""
        self.counter_samples.append((now() - self.epoch, name, float(value)))

    # -- query ------------------------------------------------------------

    def find(self, name: str | None = None, *, cat: str | None = None,
             track: str | None = None, wave: int | None = None) -> list[Span]:
        out = []
        for s in self.spans:
            if name is not None and s.name != name:
                continue
            if cat is not None and s.cat != cat:
                continue
            if track is not None and s.track != track:
                continue
            if wave is not None and s.arg("wave") != wave:
                continue
            out.append(s)
        return out

    # -- compile-trace folding -------------------------------------------

    def add_pass_traces(self, traces: Iterable) -> None:
        """Fold :class:`~repro_torch.core.cfa.passes.PassTrace` records into the
        timeline.  A PassTrace has a duration but no start time, so the
        stages are laid end-to-end on the ``compile`` track immediately
        *before* the runtime epoch — the timeline reads compile -> run."""
        traces = list(traces)
        total = sum(float(t.wall_s) for t in traces)
        at = -total
        for t in traces:
            self.spans.append(Span(
                name=f"pass:{t.name}", cat="compile", track="compile",
                t0=at, dur=float(t.wall_s),
                args=(("version", t.version), ("changed", list(t.changed))),
            ))
            at += float(t.wall_s)

    # -- plan-linked tile accounting -------------------------------------

    def tile_plan(self, pipeline, tile: tuple[int, ...]):
        """The exact :class:`TransferPlan` of ``tile`` under the
        pipeline's layout knobs (cached per tile; boundary tiles have
        smaller flow-in than the interior plan)."""
        key = tuple(int(x) for x in tile)
        plan = self._plan_cache.get(key)
        if plan is None:
            plan = _pipeline_tile_plan(pipeline, key)
            self._plan_cache[key] = plan
        return plan

    def record_read(self, pipeline, tile: tuple[int, ...]) -> dict:
        """Bump the read-side counters for one tile's ``copy_in`` and
        return the span args linking it to the tile's plan."""
        plan = self.tile_plan(pipeline, tile)
        c = self.counters
        c.add("bursts_read", plan.n_read_bursts)
        c.add("read_elems", sum(plan.read_runs))
        args = {"tile": list(tile), "wave": int(sum(tile)),
                "port": self.port, "n_read_bursts": plan.n_read_bursts,
                "facets": sorted(set(plan.read_run_hosts or ()))}
        if self.model is not None:
            b = sum(self.model.burst_bytes(r, plan.codec_bits)
                    for r in plan.read_runs)
            c.add("wire_bytes_read", b)
            args["read_bytes"] = b
        return args

    def record_write(self, pipeline, tile: tuple[int, ...]) -> dict:
        """Bump the write-side + per-tile counters for one ``copy_out``."""
        plan = self.tile_plan(pipeline, tile)
        c = self.counters
        c.add("tiles", 1)
        c.add("bursts_write", plan.n_write_bursts)
        c.add("write_elems", sum(plan.write_runs))
        if plan.stored_elems is not None and self.model is not None:
            c.add("stored_bytes", plan.stored_elems * self.model.elem_bytes)
        args = {"tile": list(tile), "wave": int(sum(tile)),
                "port": self.port, "n_write_bursts": plan.n_write_bursts,
                "facets": sorted(set(plan.write_run_hosts or ()))}
        if self.model is not None:
            b = sum(self.model.burst_bytes(r, plan.codec_bits)
                    for r in plan.write_runs)
            c.add("wire_bytes_write", b)
            args["write_bytes"] = b
        return args

    def record_halo(self, pipeline, maps: Mapping) -> dict:
        """Bump the halo counters from one tile's resolved gather maps."""
        pts = sum(len(v) for k, v in maps.items() if k != "virtual")
        virt = len(maps.get("virtual", ()))
        c = self.counters
        c.add("halo_points", pts)
        c.add("virtual_points", virt)
        indirect = pts if pipeline.storage != "redundant" else 0
        c.add("halo_indirections", indirect)
        return {"points": pts, "virtual": virt, "indirections": indirect,
                "facets": sorted(k for k in maps if k != "virtual")}

    # -- reconciliation (runtime counterpart of the CFA1xx verifier) ------

    def reconcile(self, pipeline, model=None) -> dict:
        """Check the accumulated counters and span population against an
        independent enumeration of the pipeline's per-tile plans.

        Expected totals are recomputed from scratch (fresh ``cfa_plan``
        per tile — no reuse of the recorder's cache), so a sweep that
        skipped a tile, double-committed one, or mispriced a burst shows
        up as an exact mismatch.  Checks, per the plan accounting:

        * ``tiles`` / ``waves`` — every tile visited exactly once, waves
          counted once per executor run;
        * ``bursts_read`` / ``bursts_write`` and ``read_elems`` /
          ``write_elems`` — sums of each tile plan's run counts/lengths;
        * ``wire_bytes_read + wire_bytes_write`` — equals the sum of
          ``model.plan_bytes(tile_plan)`` over all tiles, exactly;
        * span population — one ``copy_in`` and one ``copy_out`` span per
          tile, grouped per wave.

        Returns ``{"ok": bool, "expected": {...}, "observed": {...},
        "mismatches": [...]}``.
        """
        import itertools

        model = model if model is not None else self.model
        exp: dict[str, float] = {
            "tiles": 0, "bursts_read": 0, "bursts_write": 0,
            "read_elems": 0, "write_elems": 0,
        }
        if model is not None:
            exp["wire_bytes_read"] = 0.0
            exp["wire_bytes_write"] = 0.0
            exp["plan_bytes"] = 0.0
        per_wave: dict[int, int] = {}
        for tile in itertools.product(*(range(n) for n in pipeline.num_tiles)):
            plan = _pipeline_tile_plan(pipeline, tile)
            exp["tiles"] += 1
            exp["bursts_read"] += plan.n_read_bursts
            exp["bursts_write"] += plan.n_write_bursts
            exp["read_elems"] += sum(plan.read_runs)
            exp["write_elems"] += sum(plan.write_runs)
            per_wave[sum(tile)] = per_wave.get(sum(tile), 0) + 1
            if model is not None:
                exp["wire_bytes_read"] += sum(
                    model.burst_bytes(r, plan.codec_bits) for r in plan.read_runs)
                exp["wire_bytes_write"] += sum(
                    model.burst_bytes(r, plan.codec_bits) for r in plan.write_runs)
                exp["plan_bytes"] += model.plan_bytes(plan)
        exp["waves"] = len(per_wave)

        obs = {k: self.counters.get(k) for k in exp}
        obs["plan_bytes"] = (self.counters.get("wire_bytes_read")
                            + self.counters.get("wire_bytes_write")) \
            if model is not None else 0.0

        mismatches = [k for k in exp if obs[k] != exp[k]]
        # span population: one copy_in + one copy_out per tile, per wave
        for wave, n in sorted(per_wave.items()):
            for name in ("copy_in", "copy_out"):
                got = len(self.find(name, wave=wave))
                if got != n:
                    mismatches.append(f"spans:{name}@wave{wave}:{got}!={n}")
        return {"ok": not mismatches, "expected": exp, "observed": obs,
                "mismatches": mismatches}

    # -- Chrome trace-event export ---------------------------------------

    def to_chrome(self) -> dict:
        """The run as Chrome trace-event JSON (load in Perfetto or
        ``chrome://tracing``).  Schema: ``docs/tracing.md``.

        Every span becomes one complete (``"ph": "X"``) event; tracks map
        to thread ids (named via ``"M"`` metadata events) so concurrent
        lanes — the dataflow executor's fetch/compute/commit — render as
        parallel rows.  Timestamps are microseconds from the earliest
        span (compile spans included), counters ride in ``otherData``
        plus per-sample ``"C"`` events.
        """
        tracks: list[str] = []
        for s in self.spans:
            if s.track not in tracks:
                tracks.append(s.track)
        tid = {t: i + 1 for i, t in enumerate(sorted(tracks))}
        t_min = min((s.t0 for s in self.spans), default=0.0)
        events: list[dict] = [{
            "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
            "args": {"name": self.label or "repro_torch.cfa"},
        }]
        for t, i in sorted(tid.items(), key=lambda kv: kv[1]):
            events.append({"name": "thread_name", "ph": "M", "pid": 1,
                           "tid": i, "args": {"name": t}})
        for s in self.spans:
            events.append({
                "name": s.name, "cat": s.cat, "ph": "X",
                "ts": (s.t0 - t_min) * 1e6, "dur": s.dur * 1e6,
                "pid": 1, "tid": tid[s.track], "args": dict(s.args),
            })
        for t, name, value in self.counter_samples:
            events.append({
                "name": name, "cat": "counter", "ph": "C",
                "ts": (t - t_min) * 1e6, "pid": 1,
                "args": {"value": value},
            })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "label": self.label,
                "model": getattr(self.model, "name", None),
                "counters": self.counters.as_dict(),
                **self.meta,
            },
        }

    def save_chrome(self, path: Path | str) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_chrome(), indent=1))
        return path


def chrome_trace(recorder: TraceRecorder) -> dict:
    """Module-level alias for :meth:`TraceRecorder.to_chrome`."""
    return recorder.to_chrome()


def validate_chrome_trace(obj: Mapping) -> list[str]:
    """Check a trace object against the schema in ``docs/tracing.md``.

    Returns a list of problems (empty = valid).  This is what the CI
    ``trace`` job and ``tools/cfa_trace.py --validate`` run against the
    emitted JSON."""
    problems: list[str] = []
    if not isinstance(obj, Mapping):
        return ["trace must be a JSON object"]
    events = obj.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents must be a non-empty list"]
    tids_named: set[int] = set()
    for i, ev in enumerate(events):
        if not isinstance(ev, Mapping):
            problems.append(f"traceEvents[{i}] is not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "M", "C"):
            problems.append(f"traceEvents[{i}]: unknown ph {ph!r}")
            continue
        if "name" not in ev or "pid" not in ev:
            problems.append(f"traceEvents[{i}]: missing name/pid")
        if ph == "M":
            if ev.get("name") == "thread_name":
                tids_named.add(ev.get("tid"))
            continue
        if ph == "X":
            ts, dur = ev.get("ts"), ev.get("dur")
            if not isinstance(ts, (int, float)) or ts < 0:
                problems.append(f"traceEvents[{i}]: bad ts {ts!r}")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"traceEvents[{i}]: bad dur {dur!r}")
            if ev.get("cat") not in SPAN_CATS:
                problems.append(f"traceEvents[{i}]: cat must be one of "
                                f"{SPAN_CATS}: {ev.get('cat')!r}")
            if ev.get("tid") not in tids_named:
                problems.append(f"traceEvents[{i}]: tid {ev.get('tid')!r} "
                                f"has no thread_name metadata")
            if not isinstance(ev.get("args", {}), Mapping):
                problems.append(f"traceEvents[{i}]: args must be an object")
        if ph == "C" and "value" not in ev.get("args", {}):
            problems.append(f"traceEvents[{i}]: counter event without value")
    other = obj.get("otherData")
    if not isinstance(other, Mapping) or not isinstance(
            other.get("counters"), Mapping):
        problems.append("otherData.counters must be an object")
    return problems


def _pipeline_tile_plan(pipeline, tile: tuple[int, ...]):
    """One tile's :func:`cfa_plan` under a pipeline's layout knobs."""
    from .plans import cfa_plan

    ext = pipeline.ext_dirs
    return cfa_plan(
        pipeline.space, pipeline.program.deps, pipeline.tiling, tile,
        ext_dirs=dict(ext) if ext is not None else None,
        contiguity=pipeline.contiguity,
        storage=pipeline.storage,
        codec=getattr(pipeline, "codec", None),
    )


# --------------------------------------------------------------------------
# Measured-vs-modeled attribution
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Attribution:
    """One attribution row: a schedule slice (whole plan, one facet's
    runs, or one port's schedule), its observed vs modeled seconds, and
    the fixit knob (:data:`~repro_torch.core.cfa.analysis.FIXIT_KNOBS`) the
    static lint proposes for it."""

    key: str  # "plan:cfa" | "facet:0/read" | "port:1" ...
    observed_s: float
    modeled_s: float
    n_bursts: int
    fixit: str | None = None
    hint: str | None = None

    @property
    def deviation(self) -> float | None:
        """|observed - modeled| / modeled (None when modeled is 0)."""
        if self.modeled_s <= 0.0:
            return None
        return abs(self.observed_s - self.modeled_s) / self.modeled_s

    def to_dict(self) -> dict:
        return {"key": self.key, "observed_s": self.observed_s,
                "modeled_s": self.modeled_s, "n_bursts": self.n_bursts,
                "deviation": self.deviation, "fixit": self.fixit,
                "hint": self.hint}


@dataclasses.dataclass(frozen=True)
class RuntimeReport:
    """Measured-vs-modeled attribution for one plan: rows ranked worst
    deviation first, each carrying the static lint's fixit vocabulary —
    the runtime face of the CFA3xx burst-efficiency diagnostics."""

    scheme: str
    rows: tuple[Attribution, ...]
    noise: float

    @property
    def worst(self) -> Attribution:
        if not self.rows:
            raise ValueError("empty report has no worst offender")
        return self.rows[0]

    def to_dict(self) -> dict:
        return {"scheme": self.scheme, "noise": self.noise,
                "rows": [r.to_dict() for r in self.rows]}

    def summary(self) -> str:
        lines = [f"runtime report for plan:{self.scheme} "
                 f"(host noise {self.noise:.0%})"]
        for r in self.rows:
            dev = f"{r.deviation:+.0%}" if r.deviation is not None else "n/a"
            fix = f" (fixit: {r.fixit})" if r.fixit else ""
            lines.append(
                f"  {r.key}: observed {r.observed_s:.3e} s vs modeled "
                f"{r.modeled_s:.3e} s, deviation {dev}{fix}")
        return "\n".join(lines)


def runtime_report(
    plan,
    model,
    *,
    n_ports: int = 1,
    contiguity: str | None = None,
    compute_s: float = 0.0,
    overlap: bool = False,
    warmup: int | None = None,
    repeats: int | None = None,
    recorder: TraceRecorder | None = None,
) -> RuntimeReport:
    """Measure a plan's schedule slices, compare each against
    ``BurstModel.time``, and rank the deviations.

    Rows:

    * ``plan:{scheme}`` — the whole schedule (a ported plan when
      ``n_ports > 1``; ``overlap`` / ``compute_s`` compose the Fig. 13
      pipelined time exactly as ``BurstModel.time`` does);
    * ``port:{p}`` — each port's schedule, when ported;
    * ``facet:{k}/read`` / ``facet:{k}/write`` — per-facet run groups,
      when the plan attributes runs to facet hosts (CFA plans do;
      single-array baselines have no host axis to split on);

    each measured with the ``calibrate`` harness (spans emitted through
    ``recorder`` when given).  Every row carries the fixit knob of the
    matching ``lint_plan`` diagnostic — per-facet rows prefer a
    diagnostic located at that facet, any row falls back to the
    plan-level worst — so a deviation always arrives with the same
    actionable vocabulary the static analysis uses.
    """
    try:
        from .analysis import lint_plan
        from .calibrate import measure_plan, measure_runs
    except ImportError:
        raise NotImplementedError(
            "runtime_report times the plan with the calibration harness and "
            "ranks it with the burst lint; both arrive with the calibration "
            "and analysis slices of the PyTorch port"
        ) from None
    from .multiport import best_repartition
    from .bandwidth import PortedPlan

    diags = lint_plan(plan, model, n_ports=n_ports, contiguity=contiguity)
    plan_fix = next(((d.fixit, d.message) for d in diags if d.fixit), (None, None))

    def facet_fix(k: int) -> tuple[str | None, str | None]:
        for d in diags:
            if d.fixit and d.facet == k:
                return d.fixit, d.message
        return plan_fix

    target = plan
    if n_ports > 1 and not isinstance(plan, PortedPlan):
        target = best_repartition(plan, n_ports, model,
                                  compute_s=compute_s, overlap=overlap)
    kw = dict(warmup=warmup, repeats=repeats)
    cb = getattr(plan, "codec_bits", None)
    rows: list[Attribution] = []

    obs_total = measure_plan(target, model, compute_s=compute_s,
                             overlap=overlap, recorder=recorder,
                             label=f"plan:{plan.scheme}", **kw)
    rows.append(Attribution(
        key=f"plan:{plan.scheme}", observed_s=obs_total,
        modeled_s=model.time(target, compute_s=compute_s, overlap=overlap),
        n_bursts=int(target.n_bursts), fixit=plan_fix[0], hint=plan_fix[1]))

    if isinstance(target, PortedPlan):
        for p, (rr, wr) in enumerate(zip(target.read_runs_by_port,
                                         target.write_runs_by_port)):
            sched = tuple(rr) + tuple(wr)
            if not sched:
                continue
            rows.append(Attribution(
                key=f"port:{p}",
                observed_s=measure_runs(sched, model.elem_bytes,
                                        codec_bits=cb, recorder=recorder,
                                        label=f"port:{p}", **kw),
                modeled_s=model.time_s(sched, cb), n_bursts=len(sched),
                fixit=plan_fix[0], hint=plan_fix[1]))
    else:
        for side in ("read", "write"):
            runs = getattr(plan, f"{side}_runs")
            hosts = getattr(plan, f"{side}_run_hosts")
            if hosts is None:
                continue
            by_facet: dict[int, list[int]] = {}
            for r, h in zip(runs, hosts):
                by_facet.setdefault(int(h), []).append(int(r))
            for k, sched in sorted(by_facet.items()):
                fix, hint = facet_fix(k)
                rows.append(Attribution(
                    key=f"facet:{k}/{side}",
                    observed_s=measure_runs(tuple(sched), model.elem_bytes,
                                            codec_bits=cb, recorder=recorder,
                                            label=f"facet:{k}/{side}", **kw),
                    modeled_s=model.time_s(tuple(sched), cb),
                    n_bursts=len(sched), fixit=fix, hint=hint))

    rows.sort(key=lambda r: (r.deviation is not None, r.deviation or 0.0),
              reverse=True)
    return RuntimeReport(scheme=plan.scheme, rows=tuple(rows),
                         noise=measurement_noise())


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("1", "true", "on", "yes")


def trace_enabled_by_env() -> bool:
    """``REPRO_TRACE=1`` turns tracing on for every ``cfa.compile``."""
    return _env_flag("REPRO_TRACE")


def trace_export_dir() -> Path | None:
    """``REPRO_TRACE_DIR=<dir>`` auto-saves each traced run's Chrome
    trace JSON under that directory."""
    d = os.environ.get("REPRO_TRACE_DIR", "").strip()
    return Path(d) if d else None
