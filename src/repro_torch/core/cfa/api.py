"""``repro_torch.cfa.compile`` — the front door over the port's CFA stack.

The paper's pipeline (§V, Fig. 13) is one conceptual operation — pick a
burst-friendly layout, build the read→execute→write schedule, run it:

    compiled = cfa.compile("jacobi2d5p", (16, 32, 32))   # on the CUDA device
    facets   = compiled(inputs)            # the facet-storage payload
    compiled.report()                      # BurstModel bandwidth stats
    compiled.trace()                       # the per-pass lowering trace
    compiled.lower("sweep")                # rebind to another backend

``compile`` keeps the reference package's signature plus ``device``: it
seeds a :class:`~repro_torch.core.cfa.passes.CompileState` from its
arguments, runs the default :class:`~repro_torch.core.cfa.passes.PassPipeline`
(resolve_program → validate_target → distribute → layout_search →
storage_map → port_repartition → select_backend → lower_backend), and
returns the resulting :class:`CompiledStencil`.

``device`` is where facets live and every tile runs: ``"cuda"`` by default,
where the ``cuda`` backend launches the hand-written tile kernel.  Without a
card ``device="cuda"`` raises :class:`RuntimeError` — nothing falls back to
the CPU; ``device="cpu"`` is asked for explicitly, and there the kernel's
wrapper runs its plain PyTorch version.

The :class:`Target` registry holds the paper's ZC706 AXI port model, the
default, and ``h100-hbm3``, the card's burst model as the port's
measurement harness fits it.  The three facet storage disciplines
(``storage="redundant"``, ``"irredundant"``, ``"compressed"`` with a
``codec``) all run, as do multi-port execution (``n_ports > 1`` or a
``host_budget`` the space exceeds: the ``sharded`` backend, one CUDA stream
per port), the overlapped ``dataflow`` backend (``overlap=True``), int8
halo quantization (``halo_quantize=True``), the static verifier
(``verify=True``, :meth:`CompiledStencil.diagnostics`) and measured reports
(``report(measured=True)``, :meth:`CompiledStencil.runtime_report`), which
time the plan's bursts on the stencil's device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Sequence

import torch

from repro_torch.runtime import resolve_device

from .autotune import LayoutCandidate, LayoutDecision
from .bandwidth import AXI_ZC706, H100_HBM3, BandwidthReport, BurstModel
from .compress import BlockCodec
from .irredundant import rehydrate_facets
from .multiport import best_repartition
from .plans import TransferPlan
from .programs import StencilProgram
from .spaces import IterSpace
from .executors import Executor, check_backend, get_executor
from .passes import CompileState, PassPipeline, PassTrace, default_pipeline
from .transform import CFAPipeline

__all__ = [
    "Target",
    "TARGETS",
    "register_target",
    "get_target",
    "compile",
    "CompiledStencil",
    "resolve_device",
]


# --------------------------------------------------------------------------
# Target registry
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Target:
    """A memory platform: a :class:`BurstModel` plus its port budget.

    ``max_ports`` is how many independent memory ports the platform offers
    (AXI HP ports on the ZC706, HBM3 stacks on the H100); ``None`` means
    unvalidated (custom models).  ``compile`` rejects ``n_ports`` beyond
    the budget.
    """

    name: str
    model: BurstModel
    max_ports: int | None = None
    description: str = ""

    def __post_init__(self) -> None:
        if self.max_ports is not None and self.max_ports < 1:
            raise ValueError(f"max_ports must be >= 1: {self.max_ports}")


TARGETS: dict[str, Target] = {}


def register_target(target: Target, *, overwrite: bool = False) -> Target:
    if not overwrite and target.name in TARGETS:
        raise ValueError(f"target {target.name!r} is already registered")
    TARGETS[target.name] = target
    return target


register_target(Target(
    name="axi-zc706", model=AXI_ZC706, max_ports=4,
    description="the paper's Zynq ZC706: 4 AXI HP ports, 800 MB/s each (§VI-A)",
))
register_target(Target(
    name="h100-hbm3", model=H100_HBM3, max_ports=5,
    description="NVIDIA H100 SXM5 80GB: 5 active HBM3 stacks (a 5120-bit "
                "bus, NVIDIA's data sheet) as the port budget; each port of "
                "the sharded backend is a CUDA stream of the one card",
))


def get_target(target: "Target | BurstModel | str") -> Target:
    """Resolve a target name, a registered/raw :class:`BurstModel`, or a
    :class:`Target` to the registry entry (raw models wrap unvalidated)."""
    if isinstance(target, Target):
        return target
    if isinstance(target, BurstModel):
        hit = TARGETS.get(target.name)
        if hit is not None:
            if hit.model == target:
                return hit
            # a recalibrated model of a registered platform (same name,
            # tweaked parameters) keeps that platform's port budget
            return dataclasses.replace(hit, model=target)
        return Target(name=target.name, model=target)
    if isinstance(target, str):
        try:
            return TARGETS[target]
        except KeyError:
            raise ValueError(
                f"unknown target {target!r}; registered: {sorted(TARGETS)}"
            ) from None
    raise TypeError(f"target must be a Target, BurstModel or name: {target!r}")


# --------------------------------------------------------------------------
# CompiledStencil
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CompiledStencil:
    """The result of :func:`compile`: a callable stencil executable.

    ``compiled(inputs)`` runs the tiled computation through facet storage on
    the bound backend and returns the facet dict — the exact payload of
    ``CFAPipeline._sweep``, bit-identical across backends.  The layout, the
    interior-tile :class:`TransferPlan`, the modeled bandwidth
    (:meth:`report`) and the underlying :class:`CFAPipeline` ride along.
    """

    program: StencilProgram
    space: IterSpace
    target: Target
    n_ports: int
    executor: Executor
    pipeline: CFAPipeline
    layout: LayoutCandidate
    decision: LayoutDecision | None = dataclasses.field(default=None, repr=False)
    storage: str = "redundant"
    codec: BlockCodec | None = None
    # True when the distribute pass split the space over the port mesh
    distributed: bool = False
    # the per-pass lowering record (PassPipeline.run), attached by compile
    lowering: tuple = dataclasses.field(default=(), repr=False, compare=False)
    # the AnalysisReport of compile(..., verify=True); None when the
    # lowering ran without the analysis passes (diagnostics() then runs
    # the suite on demand)
    analysis: object = dataclasses.field(default=None, repr=False, compare=False)
    # compile(..., trace=True): every __call__ records a runtime trace
    trace_enabled: bool = dataclasses.field(default=False, repr=False, compare=False)
    # mutable holder for the most recent run's TraceRecorder (the stencil
    # itself is frozen); read it via last_trace()
    _trace_holder: list = dataclasses.field(default_factory=list, repr=False, compare=False)

    @property
    def backend(self) -> str:
        return self.executor.name

    @property
    def device(self) -> torch.device:
        return self.pipeline.device

    def trace(self) -> "tuple[PassTrace, ...]":
        """The per-pass lowering trace: each stage's name, version, wall
        time and the state fields it changed."""
        return self.lowering

    def diagnostics(self):
        """The static-analysis report for this stencil.

        Returns the :class:`~repro_torch.core.cfa.analysis.AnalysisReport`
        attached by ``compile(..., verify=True)``; when the lowering ran
        without the analysis passes, runs the default suite on demand
        (never raising — inspect ``report.errors`` / ``report.ok``)."""
        if self.analysis is not None:
            return self.analysis
        from . import analysis as _analysis

        return _analysis.verify(self, raise_on_error=False)

    @property
    def storage_map(self):
        """The irredundant ownership map (``None`` under redundant storage)."""
        return getattr(self.pipeline, "storage_map", None)

    def __call__(self, inputs, *, dtype=torch.float32,
                 trace: bool | None = None,
                 **opts) -> dict[int, torch.Tensor]:
        """Run the stencil: live-in planes (w0, N1, ..) → facet storage.

        ``inputs`` is a tensor or a numpy array; it is moved to the
        stencil's device and cast to ``dtype``.  ``trace`` overrides the
        compile-time ``trace=`` knob for this run: ``True`` records a
        runtime :class:`~repro_torch.core.cfa.obs.TraceRecorder` (read it
        via :meth:`last_trace`).  Its spans are host-clock spans: on the
        card they time the enqueue, not the device work."""
        inputs = torch.as_tensor(inputs)
        if trace is None:
            trace = self.trace_enabled
        if not trace:
            return self.executor.execute(
                self.pipeline, inputs, dtype=dtype, n_ports=self.n_ports, **opts,
            )
        from . import obs

        rec = obs.TraceRecorder(
            model=self.target.model,
            label=f"{self.program.name}@{'x'.join(map(str, self.space.sizes))}"
                  f"/{self.backend}",
        )
        rec.meta.update(backend=self.backend, storage=self.storage,
                        n_ports=self.n_ports, layout=self.layout.key,
                        device=str(self.device))
        rec.add_pass_traces(self.lowering)
        prev = self.pipeline.recorder
        self.pipeline.recorder = rec
        try:
            out = self.executor.execute(
                self.pipeline, inputs, dtype=dtype, n_ports=self.n_ports, **opts,
            )
        finally:
            self.pipeline.recorder = prev
            self._trace_holder[:] = [rec]
        export_dir = obs.trace_export_dir()
        if export_dir is not None:
            rec.save_chrome(export_dir / f"{rec.label.replace('/', '_')}.json")
        return out

    def last_trace(self):
        """The :class:`~repro_torch.core.cfa.obs.TraceRecorder` of the most
        recent traced run (compile spans folded in), or ``None``."""
        return self._trace_holder[-1] if self._trace_holder else None

    def runtime_report(self, **kwargs):
        """Measured-vs-modeled attribution of this stencil's interior-tile
        plan (:func:`repro_torch.core.cfa.obs.runtime_report`): per-facet /
        per-port observed time on the stencil's device vs
        ``BurstModel.time``, ranked worst deviation first, each row carrying
        the static lint's fixit."""
        from .obs import runtime_report as _rr

        kwargs.setdefault("device", self.device)
        kwargs.setdefault("n_ports", self.n_ports)
        kwargs.setdefault("contiguity", self.layout.contiguity)
        kwargs.setdefault("overlap", self.executor.caps.overlap)
        return _rr(self.plan, self.target.model, **kwargs)

    @functools.cached_property
    def plan(self) -> TransferPlan:
        """The layout's interior-tile burst schedule (§V-C) under the bound
        storage discipline, computed once."""
        return self.layout.plan(self.space, self.program,
                                storage=self.storage, codec=self.codec)

    def report(self, model: BurstModel | None = None, *,
               measured: bool = False, warmup: int | None = None,
               repeats: int | None = None,
               compute_s: float = 0.0,
               overlap: bool | None = None) -> BandwidthReport:
        """Modeled raw/effective bandwidth of one interior tile under the
        target's burst model (or ``model``); with ``n_ports > 1`` the plan
        is first repartitioned over the ports (best strategy, §VII).

        ``compute_s`` folds that much per-tile compute into the tile time;
        ``overlap`` (default: whether the bound backend declares
        ``ExecutorCaps.overlap``) picks the sequential sum or the Fig. 13
        DATAFLOW pipelined composition — see ``BurstModel.time``.

        ``measured=True`` additionally times the exact burst schedule on the
        stencil's device (``calibrate.measure_plan``, warmup + median-of-k)
        and fills the report's ``measured_time_s`` and ``model_error`` — the
        modeled time's relative error against the measurement.  When the
        stencil came from an ``autotune(score="measured")`` decision whose
        winner is this layout, the decision's stored measurement is reused
        instead of re-timing.
        """
        m = model if model is not None else self.target.model
        if overlap is None:
            overlap = self.executor.caps.overlap
        plan = self.plan
        if self.n_ports > 1:
            plan = best_repartition(plan, self.n_ports, m,
                                    compute_s=compute_s, overlap=overlap)
        measured_s = None
        if measured:
            d = self.decision
            stored = d.best if (
                d is not None and d.score == "measured"
                and model is None and warmup is None and repeats is None
                and compute_s == 0.0 and overlap == d.overlap
                and d.best.candidate == self.layout
                and d.best.measured_time_s is not None
            ) else None
            if stored is not None:
                measured_s = stored.measured_time_s
            else:
                from .calibrate import measure_plan

                measured_s = measure_plan(plan, m, warmup=warmup,
                                          repeats=repeats,
                                          compute_s=compute_s,
                                          overlap=overlap,
                                          device=self.device)
        return BandwidthReport.evaluate(plan, m, measured_s=measured_s,
                                        compute_s=compute_s, overlap=overlap)

    def lower(self, backend: str) -> "CompiledStencil":
        """Rebind to another backend (re-validated): same program, space,
        layout, storage, target and device — different executor."""
        ex = get_executor(backend)
        check_backend(ex, self.program, self.space, self.n_ports, self.storage)
        return dataclasses.replace(self, executor=ex)

    def reference(self, inputs) -> torch.Tensor:
        """The untiled oracle volume (``CFAPipeline.reference_volume``)."""
        return self.pipeline.reference_volume(torch.as_tensor(inputs))

    def rehydrate(self, facets: dict[int, torch.Tensor]) -> dict[int, torch.Tensor]:
        """Refill non-owned facet slots from their owners, turning an
        irredundant/compressed payload into the redundant layout's payload
        (identity under ``storage="redundant"``) — the bit-exactness bridge
        the tests compare across disciplines."""
        if self.storage == "redundant":
            return facets
        return rehydrate_facets(facets, self.pipeline.storage_map)

    def describe(self) -> str:
        """One-paragraph human summary (layout, storage, backend, bw)."""
        r = self.report()
        ports = f" x{self.n_ports} ports" if self.n_ports > 1 else ""
        store = "" if self.storage == "redundant" else (
            f", {self.storage} storage (footprint {r.footprint})"
        )
        return (
            f"{self.program.name} @ {self.space.sizes} -> "
            f"layout {self.layout.key}{store}, backend {self.backend} on "
            f"{self.device}, target {self.target.name}{ports}: "
            f"{r.n_bursts} bursts/tile, redundancy {r.redundancy:.1%}, "
            f"effective bw {r.peak_fraction_effective:.1%} of one port's peak"
        )


# --------------------------------------------------------------------------
# compile
# --------------------------------------------------------------------------


def compile(
    program: StencilProgram | str,
    space: IterSpace | Sequence[int],
    *,
    target: Target | BurstModel | str = AXI_ZC706,
    n_ports: int = 1,
    layout: "str | LayoutCandidate | LayoutDecision | Sequence[int]" = "autotune",
    backend: str = "auto",
    storage: str = "redundant",
    codec: "BlockCodec | str | None" = None,
    overlap: bool = False,
    autotune_kwargs: Mapping | None = None,
    host_budget: int | None = None,
    halo_quantize: bool = False,
    passes: PassPipeline | None = None,
    verify: bool = False,
    trace: bool | None = None,
    device: "torch.device | str" = "cuda",
) -> CompiledStencil:
    """Compile ``program`` on ``space`` into an executable stencil.

    The arguments are the reference package's ``repro.cfa.compile``'s:

    * ``target`` — a :class:`Target` (or registered name / BurstModel):
      the burst model scoring layouts plus the platform's port budget.
    * ``layout`` — ``"autotune"`` (default: search the layout family under
      the target's model), ``"default"`` (the paper's layout at the
      program's default tile), a :class:`LayoutCandidate`, a previous
      :class:`LayoutDecision`, or a bare tile tuple (the paper's layout at
      that tile).
    * ``n_ports`` — memory ports to repartition the facets over (§VII);
      ``> 1`` lowers to the ``sharded`` backend, checked against the
      target's port budget.
    * ``backend`` — a registered executor name, or ``"auto"``
      (:func:`repro_torch.core.cfa.executors.select_backend`: ``sharded``
      for ``n_ports > 1``, ``dataflow`` for ``overlap=True``, else ``cuda``
      on 3-D spaces when it implements the storage, ``wavefront``
      otherwise).
    * ``storage`` — the facet storage discipline (Ferry 2024):
      ``"redundant"`` (the paper's duplicated layout, default),
      ``"irredundant"`` (each value stored exactly once; halo reads take
      the owner-facet indirection), or ``"compressed"`` (irredundant +
      fixed-ratio block ``codec``); validated against the backend's
      declared ``ExecutorCaps.storages``.
    * ``codec`` — :class:`BlockCodec` or registered name for
      ``storage="compressed"`` (default ``deltapack16``); rejected loudly
      with any other storage.
    * ``overlap`` — pipeline fetch/compute/commit (the ``dataflow``
      backend, Fig. 13 DATAFLOW).
    * ``autotune_kwargs`` — passed through to :func:`autotune` when
      ``layout="autotune"`` (``seed``, ``budget``, ``cache_dir``, ...).
    * ``host_budget`` — bytes of facet storage one port may hold; a space
      whose facets exceed it is split over more ports (the ``distribute``
      pass raises ``n_ports``).
    * ``halo_quantize`` — round-trip every gathered halo piece through the
      int8 quantizer (lossy halo traffic).
    * ``passes`` — a custom :class:`~repro_torch.core.cfa.passes.PassPipeline`
      to lower with instead of the default one.
    * ``verify`` — append the static analysis suite
      (:data:`~repro_torch.core.cfa.analysis.DEFAULT_ANALYSES`) to the
      lowering: any ERROR diagnostic raises :class:`~repro_torch.core.cfa.
      analysis.VerificationError`, and the full report is surfaced as
      ``compiled.diagnostics()``.
    * ``trace`` — record a runtime :class:`~repro_torch.core.cfa.obs.
      TraceRecorder` on every call (default ``None`` follows the
      ``REPRO_TRACE`` environment knob).

    plus ``device``: the torch device facets live and tiles run on
    (``"cuda"`` by default; a missing card raises :class:`RuntimeError`).
    """
    state = CompileState(
        program=program, space=space, target=target, n_ports=n_ports,
        layout=layout, backend=backend, storage=storage, codec=codec,
        overlap=overlap,
        autotune_kwargs=dict(autotune_kwargs) if autotune_kwargs else None,
        host_budget=host_budget, halo_quantize=halo_quantize,
        device=resolve_device(device),
    )
    pipe = default_pipeline() if passes is None else passes
    if verify:
        from . import analysis as _analysis

        pipe = _analysis.verify_pipeline(pipe)
    final = pipe.run(state)
    if final.compiled is None:
        raise RuntimeError(
            f"pipeline {pipe.names} completed without producing a "
            f"CompiledStencil"
        )
    if trace is None:
        from .obs import trace_enabled_by_env

        trace = trace_enabled_by_env()
    compiled = dataclasses.replace(final.compiled, lowering=final.trace,
                                   trace_enabled=bool(trace))
    if verify:
        report = _analysis.AnalysisReport(
            tuple(final.diagnostics),
            analyses=tuple(
                (p.name, p.version) for p in pipe.passes
                if isinstance(p, _analysis.AnalysisPass)
            ),
        )
        compiled = dataclasses.replace(compiled, analysis=report)
        if report.errors:
            raise _analysis.VerificationError(report)
    return compiled
