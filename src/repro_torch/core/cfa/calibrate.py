"""Measured-vs-modeled calibration of the :class:`BurstModel`.

The PyTorch port's counterpart of the reference package's
``repro.core.cfa.calibrate``: the same measurement semantics, fit and
JSON record, with the device copy in PyTorch and a ``device=`` argument
(``"cuda"`` by default; ``"cpu"`` is asked for explicitly) on
:func:`measure_runs`, :func:`measure_plan` and :func:`calibrate`.

Every ranking the autotuner produces — layout, ports, storage, codec —
rests on the analytic burst model; this module is its measurement layer:

1. **Measure** — :func:`measure_runs` times a burst schedule for real:
   each run becomes one elementwise device op (``torch.add(src, 1.0,
   out=dst)``) over a float32 buffer pair holding the run's *wire bytes*
   (compression applied via ``compress.stored_bits``, the same formula
   :meth:`BurstModel.burst_bytes` uses), issued and synchronised on one by
   one.  The host wall clock around each op (one launch plus one
   ``torch.cuda.synchronize``) is the analogue of the per-burst descriptor
   setup cost T_setup; the per-byte copy cost is the analogue of
   bytes/BW_peak.  Warmup passes absorb the first call's context and
   allocator set-up; the reported figure is the median of k timed passes.
   :func:`measure_plan` applies this to the exact schedules
   :class:`TransferPlan` / :class:`PortedPlan` emit (a ported plan's time
   is the slowest port's schedule, matching ``BurstModel.time``).  Both
   take a ``compute_s`` term and an ``overlap=`` mode: sequential passes
   synchronise each copy then busy-spin the compute; overlapped passes
   issue every copy, spin the compute while the copies are in flight, and
   synchronise once at the end — the measured counterpart of the Fig. 13
   DATAFLOW schedule the ``dataflow`` executor runs.

2. **Fit** — :func:`fit_burst_model` least-squares fits ``t = setup_s *
   n_bursts + wire_bytes / peak_bytes_per_s`` to the single-port samples
   (columns normalised, parameters clamped non-negative) and derives
   per-port-count scaling factors from the multi-port samples, returning a
   :class:`CalibratedModel` — a drop-in :class:`BurstModel` whose
   ``time()`` additionally applies the fitted port scaling.

3. **Verify** — :func:`calibrate` sweeps synthetic burst schedules plus the
   interior-tile plans of real Table I programs across storage disciplines
   and port counts, fits the model, and records per-plan modeled-vs-
   measured relative error into a JSON-serialisable :class:`Calibration`
   (the reference's schema: either package reads the other's record).

Timing on a shared host is noisy; :func:`timing_unusable_reason` probes the
clock resolution and the spread of a reference schedule so callers can
skip with a reason instead of flaking.  ``REPRO_TIMING_TESTS=skip|force``
overrides the probe, and ``REPRO_MEASURE_WARMUP`` /
``REPRO_MEASURE_REPEATS`` override the default measurement fidelity
everywhere.  The wall clock itself (:func:`~repro_torch.core.cfa.obs.now`,
the compute stand-in :func:`~repro_torch.core.cfa.obs.burn`, the fidelity
knobs and the noise probe) lives in :mod:`repro_torch.core.cfa.obs`.
Pass ``recorder=`` (a :class:`~repro_torch.core.cfa.obs.TraceRecorder`)
to :func:`measure_runs` / :func:`measure_plan` and every timed pass is
emitted as a ``measure``-category span on the shared timeline.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from repro_torch.runtime import resolve_device

from .bandwidth import AXI_ZC706, BurstModel, PortedPlan
from .compress import get_codec, stored_bits
from .multiport import best_repartition
from .obs import (TraceRecorder, burn as _burn,
                  measure_defaults as _measure_defaults,
                  measurement_noise, now, timing_unusable_reason)
from .plans import TransferPlan, cfa_plan, interior_tile
from .spaces import IterSpace, Tiling

__all__ = [
    "TransferSample",
    "CalibratedModel",
    "Calibration",
    "CalibrationError",
    "measure_runs",
    "measure_plan",
    "fit_burst_model",
    "calibrate",
    "measurement_noise",
    "timing_unusable_reason",
]


class CalibrationError(ValueError):
    """The sample set cannot support a fit (empty, or no positive times)."""


# --------------------------------------------------------------------------
# Wire-byte accounting (shared with BurstModel.burst_bytes)
# --------------------------------------------------------------------------


def wire_bytes(length: int, elem_bytes: int, codec_bits: int | None = None) -> float:
    """Bytes one burst of ``length`` elements puts on the wire — raw, or
    header + ``codec_bits``-wide residuals under fixed-ratio compression
    (``compress.stored_bits``, the formula ``BurstModel.burst_bytes`` and
    the footprint accounting share)."""
    if not codec_bits:
        return float(length * elem_bytes)
    return stored_bits(length, 8 * elem_bytes, codec_bits) / 8


def _wire_words(length: int, elem_bytes: int, codec_bits: int | None) -> int:
    """The burst's wire bytes expressed in float32 device words (>= 1).

    The measurement buffers are float32 regardless of the model's element
    type: what the copy moves is *bytes*.
    """
    return max(1, math.ceil(wire_bytes(length, elem_bytes, codec_bits) / 4))


# --------------------------------------------------------------------------
# The measurement harness
# --------------------------------------------------------------------------

#: persistent float32 (source, destination) buffer pairs per (words, device)
_BUFFERS: dict[tuple[int, str], tuple[torch.Tensor, torch.Tensor]] = {}


def _wire_buffer(n_words: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """A persistent float32 buffer pair of ``n_words`` words on ``device``,
    created on first use."""
    key = (int(n_words), str(device))
    hit = _BUFFERS.get(key)
    if hit is None:
        src = torch.zeros((int(n_words),), dtype=torch.float32, device=device)
        hit = _BUFFERS[key] = (src, torch.empty_like(src))
    return hit


def measure_runs(
    runs: Sequence[int],
    elem_bytes: int = 8,
    *,
    codec_bits: int | None = None,
    warmup: int | None = None,
    repeats: int | None = None,
    compute_s: float = 0.0,
    overlap: bool = False,
    recorder: TraceRecorder | None = None,
    label: str = "",
    device: "torch.device | str" = "cuda",
) -> float:
    """Measured wall-clock seconds to transfer one burst schedule.

    Each run issues its own device op (sized to the run's wire bytes) on
    ``device`` and waits for it — per-burst launch and synchronisation
    overhead plus per-byte copy cost, the two terms the
    :class:`BurstModel` models.  The schedule is timed as a whole,
    ``warmup`` untimed passes first (the first CUDA call's context and
    allocator set-up happens there), then the median over ``repeats``
    timed passes.  Defaults come from ``REPRO_MEASURE_WARMUP`` /
    ``REPRO_MEASURE_REPEATS`` when unset.  An empty schedule measures 0.

    ``compute_s`` adds that much busy-spun host compute to every pass.
    Sequentially (``overlap=False``) the copies are synchronised on one by
    one and the compute runs after them — wall-clock ≈ transfer + compute.
    With ``overlap=True`` every copy is issued first, the compute spins
    while they are in flight, and the pass synchronises once at the end —
    wall-clock ≈ max(transfer, compute), the Fig. 13 DATAFLOW schedule.

    With ``recorder`` (a :class:`~repro_torch.core.cfa.obs.TraceRecorder`)
    every timed pass is emitted as a ``measure_pass`` span (category
    ``measure``, one ``measure`` summary span per schedule) carrying the
    schedule's burst count and wire bytes.
    """
    warmup, repeats = _measure_defaults(warmup, repeats)
    if compute_s < 0.0:
        raise ValueError(f"compute_s must be >= 0, got {compute_s}")
    runs = tuple(int(r) for r in runs)
    if any(r <= 0 for r in runs):
        raise ValueError(f"burst lengths must be positive: {runs}")
    if not runs and compute_s == 0.0:
        return 0.0
    dev = resolve_device(device)  # no CPU fallback for a CUDA device
    # wait for the device (the counterpart of block_until_ready); a CPU op
    # returns when it is done
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    bufs = [_wire_buffer(_wire_words(r, elem_bytes, codec_bits), dev)
            for r in runs]

    if overlap:
        def one_pass() -> float:
            t0 = now()
            for src, dst in bufs:  # issued: the copies are in flight
                torch.add(src, 1.0, out=dst)
            _burn(compute_s)
            sync()
            return now() - t0
    else:
        def one_pass() -> float:
            t0 = now()
            for src, dst in bufs:
                torch.add(src, 1.0, out=dst)
                sync()
            _burn(compute_s)
            return now() - t0

    for _ in range(warmup):
        one_pass()
    if recorder is None:
        return statistics.median(one_pass() for _ in range(repeats))

    track = f"measure/{label}" if label else "measure"
    bytes_total = sum(wire_bytes(r, elem_bytes, codec_bits) for r in runs)
    t_sched = now()
    times = []
    for i in range(repeats):
        t0 = now()
        times.append(one_pass())
        recorder.add_span("measure_pass", t0, t0 + times[-1], track=track,
                          cat="measure", label=label, n_bursts=len(runs),
                          wire_bytes=bytes_total, overlap=overlap,
                          compute_s=compute_s, index=i)
    med = statistics.median(times)
    recorder.add_span("measure", t_sched, now(), track=track, cat="measure",
                      label=label, n_bursts=len(runs),
                      wire_bytes=bytes_total, repeats=repeats,
                      warmup=warmup, median_s=med)
    recorder.counters.add("measure_passes", repeats)
    recorder.counters.add("measure_schedules", 1)
    return med


def measure_plan(
    plan: TransferPlan | PortedPlan,
    model: BurstModel,
    *,
    warmup: int | None = None,
    repeats: int | None = None,
    compute_s: float = 0.0,
    overlap: bool = False,
    recorder: TraceRecorder | None = None,
    label: str = "",
    device: "torch.device | str" = "cuda",
) -> float:
    """Measured wall-clock seconds for a whole plan under ``model``'s
    element width on ``device`` — the measured counterpart of
    :meth:`BurstModel.time`.

    A :class:`TransferPlan` times its reads and writes as one schedule; a
    :class:`PortedPlan` times each port's schedule separately and reports
    the slowest (ports run concurrently, so the tile waits for the max —
    the same §VII semantics the analytic model uses).  ``compute_s`` /
    ``overlap`` time the tile's compute alongside the schedule (each
    port's schedule overlaps the same compute term; the tile still waits
    for the slowest port) — see :func:`measure_runs`.  ``recorder``
    forwards to :func:`measure_runs` (per-port schedules get
    ``{label}/port{p}`` span labels).
    """
    cb = getattr(plan, "codec_bits", None)
    label = label or f"plan:{getattr(plan, 'scheme', '?')}"
    kw = dict(codec_bits=cb, warmup=warmup, repeats=repeats,
              compute_s=compute_s, overlap=overlap, recorder=recorder,
              device=device)
    if isinstance(plan, PortedPlan):
        return max(
            measure_runs(rr + wr, model.elem_bytes,
                         label=f"{label}/port{p}", **kw)
            for p, (rr, wr) in enumerate(zip(plan.read_runs_by_port,
                                             plan.write_runs_by_port,
                                             strict=True))
        )
    return measure_runs(plan.read_runs + plan.write_runs, model.elem_bytes,
                        label=label, **kw)


# --------------------------------------------------------------------------
# Samples + fit
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TransferSample:
    """One measured transfer point: a burst schedule and its wall-clock.

    ``runs_by_port`` holds the burst lengths (elements) per port — one
    entry for a single-port schedule.  ``codec_bits`` scales each burst's
    wire bytes under fixed-ratio compression; ``elem_bytes`` is the element
    width the schedule was measured at.
    """

    runs_by_port: tuple[tuple[int, ...], ...]
    elem_bytes: int
    measured_s: float
    codec_bits: int | None = None
    label: str = ""

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "runs_by_port",
            tuple(tuple(int(r) for r in port) for port in self.runs_by_port),
        )
        if not self.runs_by_port:
            raise ValueError("a sample needs at least one port schedule")
        if any(r <= 0 for port in self.runs_by_port for r in port):
            raise ValueError(f"burst lengths must be positive: {self.runs_by_port}")
        if self.elem_bytes < 1:
            raise ValueError(f"elem_bytes must be >= 1: {self.elem_bytes}")
        if not (self.measured_s >= 0.0 and math.isfinite(self.measured_s)):
            raise ValueError(f"measured_s must be finite and >= 0: {self.measured_s}")

    @property
    def n_ports(self) -> int:
        return len(self.runs_by_port)

    @property
    def runs(self) -> tuple[int, ...]:
        """All bursts across ports, flattened."""
        return tuple(r for port in self.runs_by_port for r in port)

    @property
    def n_bursts(self) -> int:
        return len(self.runs)

    @property
    def wire_bytes(self) -> float:
        """Total wire bytes across ports (compression applied)."""
        return sum(wire_bytes(r, self.elem_bytes, self.codec_bits)
                   for r in self.runs)


def _predict_s(model: BurstModel, sample: TransferSample) -> float:
    """Modeled time of a sample's schedule: max over its port schedules."""
    times = [model.time_s(port, sample.codec_bits)
             for port in sample.runs_by_port if port]
    return max(times) if times else 0.0


def fit_burst_model(
    samples: Sequence[TransferSample],
    base: BurstModel = AXI_ZC706,
    *,
    name: str | None = None,
) -> "CalibratedModel":
    """Fit ``base``'s parameters to measured samples.

    Least-squares on the single-port samples, ``t = setup_s * n_bursts +
    wire_bytes / peak``, with column normalisation (setup counts and byte
    totals live many orders of magnitude apart) and non-negativity clamps —
    a fitted model must keep the :class:`BurstModel` invariants (time
    monotone in run lengths, superadditive under run splitting), which any
    ``setup_s >= 0, peak > 0`` pair does.  Multi-port samples calibrate the
    port scaling: for each port count, the median ratio of measured time to
    the fitted max-over-ports prediction becomes that count's factor in
    :attr:`CalibratedModel.port_factors`.

    Raises :class:`CalibrationError` without at least one single-port
    sample with positive measured time.
    """
    single = [s for s in samples if s.n_ports == 1 and s.measured_s > 0]
    if not single:
        raise CalibrationError(
            "need at least one single-port sample with measured_s > 0 to fit"
        )
    A = np.array([[s.n_bursts, s.wire_bytes] for s in single], dtype=float)
    b = np.array([s.measured_s for s in single], dtype=float)
    col = np.linalg.norm(A, axis=0)
    col[col == 0.0] = 1.0
    x, *_ = np.linalg.lstsq(A / col, b, rcond=None)
    setup_s = float(max(x[0] / col[0], 0.0))
    per_byte = float(x[1] / col[1])
    if per_byte <= 0.0:
        # degenerate sample set (e.g. one point): fall back to the base
        # model's per-byte cost rather than inventing an infinite peak
        per_byte = 1.0 / base.peak_bytes_per_s
    fitted = BurstModel(
        name=name if name is not None else f"{base.name}+measured",
        peak_bytes_per_s=1.0 / per_byte,
        setup_s=setup_s,
        elem_bytes=base.elem_bytes,
    )
    factors: dict[int, list[float]] = {}
    for s in samples:
        if s.n_ports <= 1 or s.measured_s <= 0:
            continue
        pred = _predict_s(fitted, s)
        if pred > 0:
            factors.setdefault(s.n_ports, []).append(s.measured_s / pred)
    port_factors = tuple(
        (p, float(statistics.median(fs))) for p, fs in sorted(factors.items())
    )
    return CalibratedModel(
        name=fitted.name,
        peak_bytes_per_s=fitted.peak_bytes_per_s,
        setup_s=fitted.setup_s,
        elem_bytes=fitted.elem_bytes,
        port_factors=port_factors,
        base_name=base.name,
    )


@dataclasses.dataclass(frozen=True)
class CalibratedModel(BurstModel):
    """A :class:`BurstModel` with measured parameters — drop-in everywhere
    a burst model goes (``autotune``, ``compile(target=...)``, reports).

    ``port_factors`` maps a port count to the measured slowdown (or
    speedup) factor relative to the analytic max-over-ports time; ``time``
    applies the factor of the nearest calibrated port count to multi-port
    plans.  ``base_name`` records which preset the fit started from, so
    ``get_target`` keeps the platform's port budget for recalibrated
    models registered under the same name.
    """

    port_factors: tuple[tuple[int, float], ...] = ()
    base_name: str = ""

    def port_factor(self, n_ports: int) -> float:
        """The fitted scaling for ``n_ports`` (nearest calibrated count;
        1.0 for single-port plans or an uncalibrated port axis)."""
        if n_ports <= 1 or not self.port_factors:
            return 1.0
        table = dict(self.port_factors)
        if n_ports in table:
            return table[n_ports]
        nearest = min(table, key=lambda p: (abs(p - n_ports), p))
        return table[nearest]

    def transfer_time_s(self, plan: "TransferPlan | PortedPlan") -> float:
        # the port factor scales the *transfer*; overriding here (not
        # ``time``) lets the inherited compute/overlap composition apply
        # unchanged to calibrated models
        t = super().transfer_time_s(plan)
        return t * self.port_factor(getattr(plan, "n_ports", 1))


# --------------------------------------------------------------------------
# The full calibration sweep
# --------------------------------------------------------------------------

_SYNTH_LENGTHS = (1, 8, 64, 512, 4096, 32768)
_SYNTH_COUNTS = (1, 4, 16)
_STORAGES = ("redundant", "irredundant", "compressed")


def _program_plan(prog_name: str, storage: str,
                  space: Sequence[int] | None = None):
    """The program's interior-tile CFA plan at its default tile."""
    from .programs import get_program

    prog = get_program(prog_name)
    sizes = tuple(space) if space is not None else tuple(
        2 * t for t in prog.default_tile)
    sp, tiling = IterSpace(sizes), Tiling(prog.default_tile)
    codec = get_codec(None) if storage == "compressed" else None
    return cfa_plan(sp, prog.deps, tiling, interior_tile(sp, tiling),
                    storage=storage, codec=codec)


def calibrate(
    model: BurstModel = AXI_ZC706,
    *,
    programs: Sequence[str] = ("jacobi2d5p", "heat3d"),
    storages: Sequence[str] = _STORAGES,
    ports: Sequence[int] = (1, 2),
    lengths: Sequence[int] = _SYNTH_LENGTHS,
    counts: Sequence[int] = _SYNTH_COUNTS,
    warmup: int | None = None,
    repeats: int | None = None,
    name: str | None = None,
    overlap: bool = False,
    device: "torch.device | str" = "cuda",
) -> "Calibration":
    """Measure, fit, and verify ``model`` against ``device`` on this host.

    Two sample families feed the fit:

    * *synthetic* — every (burst length, burst count) grid point, timed as
      a uniform schedule: spans the n_bursts x bytes plane so the
      least-squares system is well conditioned;
    * *plan-derived* — the interior-tile CFA plan of each program under
      each storage discipline and port count (multi-port plans through
      ``best_repartition``): the schedules the autotuner actually ranks.

    Every plan-derived point also becomes a row of
    :attr:`Calibration.plan_errors`, recording modeled-vs-measured and
    fitted-vs-measured relative error per program.

    ``overlap=True`` additionally measures each plan's *overlapped*
    schedule at the balanced point (``compute_s`` equal to the modeled
    transfer time — where Fig. 13 DATAFLOW pipelining pays the most) and
    records a second plan-error row for it (``overlap: true``), verifying
    the overlapped model against the wall clock.  Overlapped points never
    feed the fit (the fit is transfer-only).
    """
    kw = dict(warmup=warmup, repeats=repeats, device=device)
    samples: list[TransferSample] = []
    for L in lengths:
        for c in counts:
            sched = (int(L),) * int(c)
            t = measure_runs(sched, model.elem_bytes, **kw)
            samples.append(TransferSample(
                runs_by_port=(sched,), elem_bytes=model.elem_bytes,
                measured_s=t, label=f"synthetic/{c}x{L}",
            ))
    plan_points = []  # (label fields, plan-or-ported, sample)
    for prog_name in programs:
        for storage in storages:
            plan = _program_plan(prog_name, storage)
            for p in ports:
                target_plan: TransferPlan | PortedPlan = plan
                if p > 1:
                    target_plan = best_repartition(plan, p, model)
                t = measure_plan(target_plan, model, **kw)
                if isinstance(target_plan, PortedPlan):
                    runs_by_port = tuple(
                        rr + wr for rr, wr in zip(
                            target_plan.read_runs_by_port,
                            target_plan.write_runs_by_port, strict=True)
                        if rr + wr
                    )
                else:
                    runs_by_port = (plan.read_runs + plan.write_runs,)
                sample = TransferSample(
                    runs_by_port=runs_by_port,
                    elem_bytes=model.elem_bytes,
                    measured_s=t,
                    codec_bits=plan.codec_bits,
                    label=f"{prog_name}/{storage}/p{p}",
                )
                samples.append(sample)
                plan_points.append((prog_name, storage, p, target_plan,
                                    t, False, 0.0))
                if overlap:
                    # balanced point: compute exactly hides the transfer
                    c = model.transfer_time_s(target_plan)
                    t_ovl = measure_plan(target_plan, model,
                                         compute_s=c, overlap=True, **kw)
                    plan_points.append((prog_name, storage, p, target_plan,
                                        t_ovl, True, c))

    fitted = fit_burst_model(samples, model, name=name)

    rows = []
    for prog_name, storage, p, target_plan, t, ovl, c in plan_points:
        modeled = model.time(target_plan, compute_s=c, overlap=ovl)
        predicted = fitted.time(target_plan, compute_s=c, overlap=ovl)
        rows.append({
            "program": prog_name,
            "storage": storage,
            "n_ports": int(p),
            "codec_bits": getattr(target_plan, "codec_bits", None),
            "n_bursts": int(target_plan.n_bursts),
            "overlap": bool(ovl),
            "compute_s": float(c),
            "modeled_s": float(modeled),
            "fitted_s": float(predicted),
            "measured_s": float(t),
            "rel_err_modeled": _rel_err(modeled, t),
            "rel_err_fitted": _rel_err(predicted, t),
        })

    from .executors import host_fingerprint

    return Calibration(
        target=model.name,
        base=model,
        fitted=fitted,
        samples=tuple(samples),
        plan_errors=tuple(rows),
        noise=measurement_noise(device),
        host=tuple(tuple(kv) for kv in host_fingerprint()),
    )


def _rel_err(predicted: float, measured: float) -> float | None:
    """|predicted - measured| / measured (None when measured is 0)."""
    if measured <= 0.0:
        return None
    return abs(predicted - measured) / measured


@dataclasses.dataclass(frozen=True)
class Calibration:
    """The outcome of one :func:`calibrate` run (JSON round-trippable).

    ``base`` is the analytic model that was calibrated, ``fitted`` the
    measured replacement, ``samples`` everything that fed the fit, and
    ``plan_errors`` one row per (program, storage, ports) plan with
    modeled-vs-measured and fitted-vs-measured relative error — the
    numbers the acceptance criteria audit.
    """

    target: str
    base: BurstModel
    fitted: CalibratedModel
    samples: tuple[TransferSample, ...]
    plan_errors: tuple[dict, ...]
    noise: float
    host: tuple[tuple[str, str], ...]

    def max_rel_err(self, which: str = "fitted") -> float:
        """Worst relative error over the plan rows (``"fitted"`` or
        ``"modeled"``); 0.0 when no row has a measurable error."""
        key = f"rel_err_{which}"
        errs = [r[key] for r in self.plan_errors if r.get(key) is not None]
        return max(errs) if errs else 0.0

    def summary(self) -> str:
        f = self.fitted
        lines = [
            f"calibration of {self.target}: {len(self.samples)} samples, "
            f"noise {self.noise:.1%}",
            f"  base:   setup {self.base.setup_s:.3e} s, "
            f"peak {self.base.peak_bytes_per_s:.3e} B/s",
            f"  fitted: setup {f.setup_s:.3e} s, "
            f"peak {f.peak_bytes_per_s:.3e} B/s, "
            f"port factors {dict(f.port_factors) or '{}'}",
            f"  plan error: modeled max {self.max_rel_err('modeled'):.1%}, "
            f"fitted max {self.max_rel_err('fitted'):.1%} "
            f"over {len(self.plan_errors)} plan(s)",
        ]
        return "\n".join(lines)

    # -- serialisation ------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1)

    @staticmethod
    def from_json(text: str) -> "Calibration":
        d = json.loads(text)
        base = BurstModel(**d["base"])
        f = d["fitted"]
        fitted = CalibratedModel(
            name=f["name"], peak_bytes_per_s=f["peak_bytes_per_s"],
            setup_s=f["setup_s"], elem_bytes=f["elem_bytes"],
            port_factors=tuple((int(p), float(x)) for p, x in f["port_factors"]),
            base_name=f.get("base_name", ""),
        )
        samples = tuple(
            TransferSample(
                runs_by_port=tuple(tuple(port) for port in s["runs_by_port"]),
                elem_bytes=s["elem_bytes"],
                measured_s=s["measured_s"],
                codec_bits=s["codec_bits"],
                label=s["label"],
            )
            for s in d["samples"]
        )
        return Calibration(
            target=d["target"],
            base=base,
            fitted=fitted,
            samples=samples,
            plan_errors=tuple(d["plan_errors"]),
            noise=d["noise"],
            host=tuple(tuple(kv) for kv in d["host"]),
        )

    def save(self, path: Path | str) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json())
        return path
