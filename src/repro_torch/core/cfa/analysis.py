"""Static plan verification and burst lint — compile-time diagnostics.

The PyTorch port's copy of the reference package's analysis layer
(``repro.core.cfa.analysis``); numpy only, so the code is the reference's
with its imports pointed into ``repro_torch``.  Its checks speak of the
port's executor registry (``cuda``, ``sharded``, ``dataflow``,
``reference``, ``sweep``, ``wavefront``), and :func:`verify` rebuilds a
stencil's compile state on the stencil's own device.

An element-wise access pattern silently destroys effective bandwidth, and
a burst-hostile or *incorrect* plan (a double-written facet slot, an
unresolved halo owner, an illegal overlap schedule) would otherwise only
be caught by running it.  This module turns both into *static*
diagnostics that run inside the pass pipeline, before any executor is
invoked.

It adds a second pass category to :class:`~repro_torch.core.cfa.passes.
PassPipeline`: **analysis passes** (:class:`AnalysisPass` /
:func:`analysis_pass`) are read-only — they consume a ``CompileState`` and
append :class:`Diagnostic` records to ``state.diagnostics`` instead of
mutating lowering artifacts.  Four ship by default (:data:`DEFAULT_ANALYSES`):

* ``verify_single_assignment`` (**CFA1xx**) — every facet-family element
  is written exactly once (per-facet address injectivity), under
  ``storage="irredundant"`` the owner masks partition the family and every
  halo read resolves to exactly one owner, plus ``TransferPlan``
  accounting (writes vs stored slots, reads vs needed elements).
* ``verify_overlap`` (**CFA2xx**) — a static wave-dependence check that
  the dataflow backend's prefetch-of-``j+1`` / deferred-commit-of-``j-1``
  schedule never aliases tile ``j``'s reads or writes.
* ``lint_bursts`` (**CFA3xx**) — runs shorter than the bound target's
  efficient-burst knee, contiguity breaks, redundancy above threshold,
  port-load imbalance — each priced in modeled seconds via
  :class:`~repro_torch.core.cfa.bandwidth.BurstModel`.
* ``verify_contracts`` (**CFA4xx**) — backend caps vs the lowered state,
  codec exactness preconditions, port budgets.

Every :class:`Diagnostic` carries a stable code, a severity
(``ERROR``/``WARN``/``INFO``), an optional facet/run location, a human
message, a machine-readable ``fixit`` naming the layout knob to turn
(``ext_dirs``, ``contiguity``, ``storage``, ``n_ports``), and — for the
priced lints — ``cost_s``, the modeled seconds the flagged inefficiency
costs per tile.  The code table is in ``docs/analysis.md``.

Entry points: :func:`verify` checks a :class:`~repro_torch.core.cfa.api.
CompiledStencil` post-hoc (``plan=``/``waves=`` inject corrupted artifacts
for mutation testing); ``cfa.compile(..., verify=True)`` appends
:func:`verify_pipeline`'s analysis stages to the lowering and raises
:class:`VerificationError` on any ERROR; ``autotune`` discards candidates
whose plans fail :func:`plan_accounting`.
"""
from __future__ import annotations

import dataclasses
import inspect
import itertools
import json
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np

from .bandwidth import BurstModel
from .facets import build_facet_specs
from .irredundant import build_storage_map, owner_of
from .passes import CompileState
from .plans import TransferPlan, cfa_piece_census, interior_tile
from .spaces import (
    Deps,
    IterSpace,
    Tiling,
    facet_points,
    facet_widths,
    flow_in_points,
)

__all__ = [
    "SEVERITIES",
    "FIXIT_KNOBS",
    "Diagnostic",
    "AnalysisReport",
    "VerificationError",
    "AnalysisPass",
    "analysis_pass",
    "DEFAULT_ANALYSES",
    "verify_single_assignment",
    "verify_overlap",
    "lint_bursts",
    "verify_contracts",
    "check_facet_family",
    "check_overlap_schedule",
    "plan_accounting",
    "lint_plan",
    "run_analyses",
    "verify",
    "verify_pipeline",
]

#: Diagnostic severities, weakest first (``max_severity`` compares by index).
SEVERITIES = ("INFO", "WARN", "ERROR")

#: The layout knobs a ``fixit`` may name — each is a ``cfa.compile`` /
#: ``LayoutCandidate`` parameter the user can actually turn.
FIXIT_KNOBS = ("ext_dirs", "contiguity", "storage", "n_ports")

# -- lint thresholds (CFA3xx) ------------------------------------------------
#: CFA301 fires when burst-setup time exceeds this share of the modeled
#: transfer time — the plan is descriptor-bound, not bandwidth-bound.
SETUP_SHARE_WARN = 0.5
#: CFA303 fires when more than this fraction of transferred elements are
#: redundant (duplicated halo traffic the irredundant discipline removes).
REDUNDANCY_WARN = 0.5
#: CFA304 fires when the best repartition's max/mean port load exceeds this.
BALANCE_WARN = 1.5


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One static finding: a stable code, a severity, a located message.

    ``analysis`` names the emitting analysis pass (filled by the pass
    wrapper); ``facet``/``run`` locate the finding inside the layout when
    applicable; ``fixit`` is the machine-readable remediation — one of
    :data:`FIXIT_KNOBS`, the compile knob whose change addresses the
    finding; ``cost_s`` prices the inefficiency in modeled seconds per tile
    (CFA3xx lints only).
    """

    code: str
    severity: str
    message: str
    analysis: str = ""
    facet: int | None = None
    run: int | None = None
    fixit: str | None = None
    cost_s: float | None = None

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}: {self.severity!r}"
            )
        if self.fixit is not None and self.fixit not in FIXIT_KNOBS:
            raise ValueError(
                f"fixit must be one of {FIXIT_KNOBS}: {self.fixit!r}"
            )

    def to_dict(self) -> dict:
        """JSON-ready record; location/fixit/cost keys appear only when set."""
        out = {
            "code": self.code,
            "severity": self.severity,
            "analysis": self.analysis,
            "message": self.message,
        }
        for key in ("facet", "run", "fixit", "cost_s"):
            v = getattr(self, key)
            if v is not None:
                out[key] = v
        return out

    def __str__(self) -> str:
        loc = f" [facet {self.facet}]" if self.facet is not None else ""
        fix = f" (fixit: {self.fixit})" if self.fixit else ""
        return f"{self.severity} {self.code}{loc}: {self.message}{fix}"


@dataclasses.dataclass(frozen=True)
class AnalysisReport:
    """The aggregate of one verification run: every diagnostic, plus the
    (name, version) fingerprint of the analyses that produced them."""

    diagnostics: tuple[Diagnostic, ...]
    analyses: tuple[tuple[str, str], ...] = ()

    def _with_severity(self, severity: str) -> tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.severity == severity)

    @property
    def errors(self) -> tuple[Diagnostic, ...]:
        return self._with_severity("ERROR")

    @property
    def warnings(self) -> tuple[Diagnostic, ...]:
        return self._with_severity("WARN")

    @property
    def infos(self) -> tuple[Diagnostic, ...]:
        return self._with_severity("INFO")

    @property
    def ok(self) -> bool:
        """True when no ERROR diagnostic fired (WARN/INFO are advisory)."""
        return not self.errors

    @property
    def max_severity(self) -> str | None:
        """The worst severity present, ``None`` on a clean report."""
        if not self.diagnostics:
            return None
        return max((d.severity for d in self.diagnostics),
                   key=SEVERITIES.index)

    @property
    def codes(self) -> tuple[str, ...]:
        """The distinct diagnostic codes present, sorted."""
        return tuple(sorted({d.code for d in self.diagnostics}))

    def by_code(self, code: str) -> tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.code == code)

    def to_dict(self) -> dict:
        return {
            "analyses": [list(a) for a in self.analyses],
            "max_severity": self.max_severity,
            "diagnostics": [d.to_dict() for d in self.diagnostics],
        }

    def to_json(self, *, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def summary(self) -> str:
        """Human one-or-more-line rendering (what ``cfa_lint`` prints)."""
        if not self.diagnostics:
            return "clean: no diagnostics"
        head = ", ".join(
            f"{len(self._with_severity(s))} {s}"
            for s in reversed(SEVERITIES) if self._with_severity(s)
        )
        lines = [f"{len(self.diagnostics)} diagnostic(s): {head}"]
        lines += [f"  {d}" for d in sorted(
            self.diagnostics,
            key=lambda d: (-SEVERITIES.index(d.severity), d.code))]
        return "\n".join(lines)


class VerificationError(ValueError):
    """Static verification rejected the plan; carries the full report."""

    def __init__(self, report: AnalysisReport, *, strict: bool = False):
        self.report = report
        bad = report.errors + (report.warnings if strict else ())
        shown = "; ".join(f"{d.code}: {d.message}" for d in bad[:4])
        more = f" (+{len(bad) - 4} more)" if len(bad) > 4 else ""
        kind = "ERROR/WARN" if strict else "ERROR"
        super().__init__(
            f"plan verification failed with {len(bad)} {kind} "
            f"diagnostic(s): {shown}{more}"
        )


# --------------------------------------------------------------------------
# The analysis-pass category
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AnalysisPass:
    """A read-only pass: consumes a ``CompileState``, emits ``Diagnostic``s.

    Satisfies the :class:`~repro_torch.core.cfa.passes.Pass` protocol —
    ``requires=("compiled",)`` places it after ``lower_backend`` and
    ``provides=()`` keeps it out of the artifact dependency graph — but its
    ``run`` only *appends* to ``state.diagnostics``; lowering artifacts are
    never touched.  ``codes`` declares the stable diagnostic codes the pass
    may emit (documented in ``docs/analysis.md``).
    """

    name: str
    version: str
    fn: Callable[..., Iterable[Diagnostic]] = dataclasses.field(compare=False)
    codes: tuple[str, ...] = ()
    requires: tuple[str, ...] = ("compiled",)
    provides: tuple[str, ...] = ()

    def run(self, state: CompileState) -> CompileState:
        return dataclasses.replace(
            state,
            diagnostics=tuple(state.diagnostics) + self.diagnose(state),
        )

    def diagnose(self, state: CompileState, **overrides: Any) -> tuple[Diagnostic, ...]:
        """Run the checker directly (outside a pipeline), tagging each
        diagnostic with this pass's name.  ``overrides`` (``plan=``,
        ``waves=``) substitute corrupted artifacts for mutation testing;
        keys the underlying checker does not accept are dropped."""
        if overrides:
            params = inspect.signature(self.fn).parameters
            if not any(p.kind is inspect.Parameter.VAR_KEYWORD
                       for p in params.values()):
                overrides = {k: v for k, v in overrides.items() if k in params}
        out = tuple(self.fn(state, **overrides))
        return tuple(
            d if d.analysis else dataclasses.replace(d, analysis=self.name)
            for d in out
        )


def analysis_pass(
    name: str,
    version: str = "1",
    *,
    codes: Sequence[str] = (),
):
    """Decorator turning ``fn(state, ...) -> Iterable[Diagnostic]`` into a
    registered :class:`AnalysisPass` (the read-only counterpart of
    :func:`~repro_torch.core.cfa.passes.compiler_pass`)."""

    def deco(fn: Callable[..., Iterable[Diagnostic]]) -> AnalysisPass:
        return AnalysisPass(name=name, version=version, fn=fn,
                            codes=tuple(codes))

    return deco


# --------------------------------------------------------------------------
# Pure checkers (geometry- and plan-level; no CompileState required)
# --------------------------------------------------------------------------


def _stored_counts(smap, pts: np.ndarray) -> np.ndarray:
    """How many facets *store* each canonical point under ``smap`` (the
    irredundant discipline's slot count — exactly 1 iff a partition)."""
    counts = np.zeros(len(pts), dtype=np.int64)
    for k in smap.specs:
        counts += smap.stores(k, pts)
    return counts


def check_facet_family(
    space: IterSpace,
    deps: Deps,
    tiling: Tiling,
    *,
    ext_dirs: Mapping[int, int] | None = None,
    contiguity: str = "intra-tile",
    storage: str = "redundant",
) -> list[Diagnostic]:
    """The CFA1xx geometric proofs for one facet family (interior tile).

    * **CFA101** — a facet's address map collides on its own facet point
      set: two writes land in the same slot (single assignment broken).
    * **CFA103** — a flow-in (halo) point resolves to no facet domain
      (redundant) or to no stored owner slot (irredundant) — the read has
      nowhere to come from.
    * **CFA104** — under ``storage != "redundant"`` the owner masks fail to
      *partition* the facet-point union (a gap or an overlap), or a halo
      read resolves to more than one stored slot.

    These are exhaustive checks over the interior tile's point sets — the
    static counterpart of the sampled Hypothesis properties — and apply to
    every tile by translation invariance of the facet layout.
    """
    diags: list[Diagnostic] = []
    widths = facet_widths(deps)
    specs = build_facet_specs(space, deps, tiling, ext_dirs=ext_dirs,
                              contiguity=contiguity)
    tile = interior_tile(space, tiling)

    # CFA101: per-facet write injectivity over the facet point set
    fpts_by_k: dict[int, np.ndarray] = {}
    for k, spec in specs.items():
        fpts = facet_points(tiling, widths, k, tile)
        fpts_by_k[k] = fpts
        offs = spec.offsets(fpts)
        n_dup = len(offs) - len(np.unique(offs))
        if n_dup:
            diags.append(Diagnostic(
                "CFA101", "ERROR",
                f"facet_{k}: {n_dup} of {len(offs)} facet-slot writes "
                f"collide — the address map is not injective on the facet "
                f"point set (single assignment broken)",
                facet=k,
            ))

    fin = flow_in_points(space, deps, tiling, tile)

    if storage == "redundant":
        # CFA103: every halo point must lie in at least one facet domain
        # (the appendix coverage proof, checked rather than trusted)
        if len(fin):
            missing = int((owner_of(specs, fin) < 0).sum())
            if missing:
                diags.append(Diagnostic(
                    "CFA103", "ERROR",
                    f"{missing} of {len(fin)} flow-in points lie outside "
                    f"every facet projection domain — the halo read has no "
                    f"source array",
                ))
        return diags

    # irredundant / compressed: the owner masks must partition the family
    smap = build_storage_map(specs)
    union = (np.unique(np.concatenate(list(fpts_by_k.values()), axis=0), axis=0)
             if fpts_by_k else np.empty((0, space.ndim), dtype=np.int64))
    if len(union):
        counts = _stored_counts(smap, union)
        gaps, dups = int((counts == 0).sum()), int((counts > 1).sum())
        if gaps:
            diags.append(Diagnostic(
                "CFA104", "ERROR",
                f"owner masks leave {gaps} of {len(union)} facet-family "
                f"points unstored — the partition has gaps (those values "
                f"are lost on commit)",
            ))
        if dups:
            diags.append(Diagnostic(
                "CFA104", "ERROR",
                f"owner masks store {dups} of {len(union)} facet-family "
                f"points more than once — the partition overlaps (single "
                f"assignment broken)",
            ))
    if len(fin):
        # every halo read must resolve to exactly one stored owner slot
        counts = _stored_counts(smap, fin)
        unresolved = int((counts == 0).sum())
        multi = int((counts > 1).sum())
        if unresolved:
            diags.append(Diagnostic(
                "CFA103", "ERROR",
                f"{unresolved} of {len(fin)} halo reads resolve to no "
                f"stored owner slot — irredundant storage never wrote the "
                f"value they need",
            ))
        if multi:
            diags.append(Diagnostic(
                "CFA104", "ERROR",
                f"{multi} of {len(fin)} halo reads resolve to more than "
                f"one stored owner slot — ownership is ambiguous",
            ))
    return diags


def plan_accounting(plan: TransferPlan) -> list[Diagnostic]:
    """The CFA1xx accounting checks on a :class:`TransferPlan` — O(#runs).

    * **CFA101** — a CFA plan whose writes transfer *more* elements than
      the layout stores: some slot is written more than once (e.g. a
      duplicated write run).
    * **CFA102** — writes transfer *fewer* elements than the layout stores
      (CFA plans) or than the tile produces (baselines): some slot or
      result is never committed (e.g. a dropped owner block).
    * **CFA105** — reads transfer fewer elements than the tile consumes:
      some halo value is never fetched.

    Cheap enough that ``autotune`` runs it on every candidate plan and
    discards ERROR-level candidates during the search.
    """
    diags: list[Diagnostic] = []
    rt, ru = plan.read_transferred, plan.read_useful
    if rt < ru:
        diags.append(Diagnostic(
            "CFA105", "ERROR",
            f"reads transfer {rt} elements but the tile consumes {ru} — "
            f"{ru - rt} halo element(s) are never fetched",
        ))
    wt = plan.write_transferred
    stored = plan.stored_elems
    if stored is not None and plan.scheme.startswith("cfa"):
        if wt > stored:
            diags.append(Diagnostic(
                "CFA101", "ERROR",
                f"writes transfer {wt} elements but the layout stores only "
                f"{stored} slots per tile — {wt - stored} slot(s) written "
                f"more than once (single assignment broken)",
            ))
        elif wt < stored:
            diags.append(Diagnostic(
                "CFA102", "ERROR",
                f"writes transfer {wt} of the {stored} slots the layout "
                f"stores per tile — {stored - wt} slot(s) never written",
            ))
    elif wt < plan.write_useful:
        diags.append(Diagnostic(
            "CFA102", "ERROR",
            f"writes transfer {wt} elements but the tile produces "
            f"{plan.write_useful} flow-out values — some results are never "
            f"committed",
        ))
    return diags


def check_overlap_schedule(
    space: IterSpace,
    deps: Deps,
    tiling: Tiling,
    waves: Sequence[Sequence[Sequence[int]]] | None = None,
) -> list[Diagnostic]:
    """The CFA2xx static wave-dependence check.

    The dataflow backend pipelines ``prefetch(wave[j+1])`` with
    ``compute(wave[j])`` and ``deferred-commit(wave[j-1])``; that schedule
    is race-free iff every tile dependence points *strictly backwards* in
    wave order — a producer in the same wave (**CFA201**) means the
    prefetch of a consumer races the producer's deferred commit, and a
    producer in a *later* wave (**CFA202**) means the schedule reads a
    value before it exists at all.  ``waves`` defaults to the coordinate-sum
    grouping of ``CFAPipeline.wavefronts`` (provably legal for backward
    dependence vectors); pass an explicit grouping to audit — or corrupt —
    a custom schedule.
    """
    nt = tiling.num_tiles(space)
    all_tiles = list(itertools.product(*(range(n) for n in nt)))
    if waves is None:
        by_sum: dict[int, list[tuple[int, ...]]] = {}
        for q in all_tiles:
            by_sum.setdefault(sum(q), []).append(q)
        waves = [by_sum[s] for s in sorted(by_sum)]
    wave_of: dict[tuple[int, ...], int] = {}
    for i, wv in enumerate(waves):
        for q in wv:
            wave_of[tuple(int(c) for c in q)] = i

    diags: list[Diagnostic] = []
    missing = [q for q in all_tiles if q not in wave_of]
    if missing:
        diags.append(Diagnostic(
            "CFA202", "ERROR",
            f"schedule omits {len(missing)} of {len(all_tiles)} tiles "
            f"(e.g. {missing[0]}) — those tiles never execute",
        ))

    # backward tile dependences, read off the interior tile's flow-in
    tile = interior_tile(space, tiling)
    fin = flow_in_points(space, deps, tiling, tile)
    if not len(fin):
        return diags
    t = np.asarray(tiling.sizes, dtype=np.int64)
    deltas = np.unique(fin // t - np.asarray(tile, dtype=np.int64), axis=0)

    same = cross = 0
    example_same = example_cross = None
    for q in all_tiles:
        wq = wave_of.get(q)
        if wq is None:
            continue
        for dlt in deltas:
            src = tuple(int(c) for c in np.asarray(q) + dlt)
            if any(c < 0 for c in src):
                continue  # boundary tile: that neighbour does not exist
            ws = wave_of.get(src)
            if ws is None:
                continue  # already reported as missing
            if ws == wq:
                same += 1
                example_same = example_same or (src, q, wq)
            elif ws > wq:
                cross += 1
                example_cross = example_cross or (src, q)
    if same:
        src, q, w = example_same
        diags.append(Diagnostic(
            "CFA201", "ERROR",
            f"{same} tile dependence(s) fall within a single wave (e.g. "
            f"tile {q} reads tile {src}, both in wave {w}) — the dataflow "
            f"prefetch of the consumer races the producer's deferred "
            f"commit; overlap=True must be rejected for this schedule",
        ))
    if cross:
        src, q = example_cross
        diags.append(Diagnostic(
            "CFA202", "ERROR",
            f"{cross} tile dependence(s) point to a later wave (e.g. tile "
            f"{q} reads tile {src}, scheduled after it) — the schedule "
            f"consumes values before they are produced",
        ))
    return diags


def lint_plan(
    plan: TransferPlan,
    model: BurstModel,
    *,
    n_ports: int = 1,
    contiguity: str | None = None,
    expected_read_bursts: int | None = None,
    assignment=None,
) -> list[Diagnostic]:
    """The CFA3xx burst-efficiency lint, priced under ``model``.

    * **CFA301** — burst-hostile schedule: runs shorter than the model's
      efficient-burst knee (``BurstModel.setup_elems``) *and* descriptor
      setup above :data:`SETUP_SHARE_WARN` of the modeled transfer time
      (the Memory Controller Wall regime: the plan is descriptor-bound).
    * **CFA302** — contiguity break: more read bursts than the intra-tile
      layout family achieves (WARN, ``fixit="ext_dirs"``), or a weaker
      contiguity level selected at all (INFO, ``fixit="contiguity"``).
    * **CFA303** — redundancy above :data:`REDUNDANCY_WARN`: more than
      half the transferred elements are duplicated halo traffic.
    * **CFA304** — port-load imbalance beyond :data:`BALANCE_WARN` under
      ``assignment`` (the compile-time facet -> port split, whose whole
      facet arrays are atomic and so *can* be lopsided), falling back to
      the best burst-granular §VII repartition over ``n_ports``.

    ``cost_s`` on each diagnostic is the modeled seconds per tile the
    flagged inefficiency costs (recoverable descriptor time, excess-burst
    setup, redundant bytes, slowest-vs-mean port gap).
    """
    diags: list[Diagnostic] = []
    runs = tuple(plan.read_runs) + tuple(plan.write_runs)
    if runs:
        knee = model.setup_elems
        short = [r for r in runs if r < knee]
        setup_total = plan.n_bursts * model.setup_s
        transfer = model.transfer_time_s(plan)
        share = setup_total / transfer if transfer > 0.0 else 0.0
        if short and share > SETUP_SHARE_WARN:
            # the recoverable cost: everything beyond one setup per source
            # array (the best any contiguity fix could reach)
            ideal = (len(set(plan.read_run_hosts)) if plan.read_run_hosts
                     else 1) + (len(set(plan.write_run_hosts))
                                if plan.write_run_hosts else 1)
            diags.append(Diagnostic(
                "CFA301", "WARN",
                f"burst-hostile schedule: {len(short)} of {len(runs)} runs "
                f"are shorter than the {model.name} efficient-burst knee "
                f"(~{knee:.0f} elems) and descriptor setup is {share:.0%} "
                f"of the modeled transfer time",
                fixit="contiguity",
                cost_s=max(0, plan.n_bursts - ideal) * model.setup_s,
            ))
    if (expected_read_bursts is not None
            and plan.n_read_bursts > expected_read_bursts):
        extra = plan.n_read_bursts - expected_read_bursts
        diags.append(Diagnostic(
            "CFA302", "WARN",
            f"{plan.n_read_bursts} read bursts where the intra-tile layout "
            f"family achieves {expected_read_bursts} — {extra} contiguity "
            f"break(s); a different extension-direction assignment merges "
            f"them (§IV-H)",
            fixit="ext_dirs",
            cost_s=extra * model.setup_s,
        ))
    if contiguity is not None and contiguity != "intra-tile":
        diags.append(Diagnostic(
            "CFA302", "INFO",
            f"contiguity level {contiguity!r}: corner reads do not merge "
            f"into facet-block suffixes (§IV-I) — the intra-tile level "
            f"reaches the paper's minimal burst count",
            fixit="contiguity",
        ))
    if plan.redundancy > REDUNDANCY_WARN and plan.storage == "redundant":
        # irredundant/compressed plans already took the storage fixit: their
        # remaining transfer overhead is owner indirection, not duplication
        wasted = plan.transferred - plan.useful
        diags.append(Diagnostic(
            "CFA303", "WARN",
            f"redundancy {plan.redundancy:.0%}: {wasted} of "
            f"{plan.transferred} transferred elements are duplicated halo "
            f"traffic — the irredundant discipline stores each value once",
            fixit="storage",
            cost_s=wasted * model.elem_bytes / model.peak_bytes_per_s,
        ))
    if n_ports > 1:
        times = how = None
        if (assignment is not None and plan.read_run_hosts is not None
                and plan.write_run_hosts is not None):
            by_port: list[list[int]] = [[] for _ in range(n_ports)]
            for rs, hosts in ((plan.read_runs, plan.read_run_hosts),
                              (plan.write_runs, plan.write_run_hosts)):
                for r, h in zip(rs, hosts):
                    by_port[assignment.facet_to_port[h]].append(r)
            times = [model.time_s(tuple(rs), plan.codec_bits) if rs else 0.0
                     for rs in by_port]
            how = "the compile-time facet->port assignment"
        else:
            from .multiport import best_repartition

            ported = best_repartition(plan, n_ports, model)
            times = [
                model.time_s(rr, ported.codec_bits)
                + model.time_s(wr, ported.codec_bits)
                for rr, wr in zip(ported.read_runs_by_port,
                                  ported.write_runs_by_port)
            ]
            how = f"the best repartition strategy {ported.strategy!r}"
        busy = [t for t in times if t > 0.0]
        if busy:
            mean = sum(busy) / len(busy)
            balance = max(busy) / mean
            if balance > BALANCE_WARN:
                diags.append(Diagnostic(
                    "CFA304", "WARN",
                    f"port-load imbalance {balance:.2f} (max/mean over "
                    f"{len(busy)} busy of {n_ports} ports, tolerance "
                    f"{BALANCE_WARN}) under {how} — the slowest port gates "
                    f"the tile",
                    fixit="n_ports",
                    cost_s=max(busy) - mean,
                ))
    return diags


# --------------------------------------------------------------------------
# The four default analyses (CompileState wrappers over the pure checkers)
# --------------------------------------------------------------------------


def _plan_of(state: CompileState) -> TransferPlan | None:
    """The state's interior-tile plan: the compiled stencil's cached one,
    else derived from the layout candidate; None before layout_search."""
    if state.compiled is not None:
        return state.compiled.plan
    cand = state.candidate
    if cand is None or not isinstance(state.space, IterSpace):
        return None
    return cand.plan(state.space, state.program, storage=state.storage,
                     codec=state.codec)


def _cfa_family_kwargs(cand) -> dict:
    return dict(
        ext_dirs=dict(cand.ext_dirs) if cand.ext_dirs is not None else None,
        contiguity=cand.contiguity or "intra-tile",
    )


def _is_cfa_state(state: CompileState) -> bool:
    return (state.candidate is not None
            and getattr(state.candidate, "scheme", None) == "cfa"
            and isinstance(state.space, IterSpace)
            and hasattr(state.program, "deps"))


@analysis_pass("verify_single_assignment",
               codes=("CFA101", "CFA102", "CFA103", "CFA104", "CFA105"))
def verify_single_assignment(
    state: CompileState, *, plan: TransferPlan | None = None,
) -> list[Diagnostic]:
    """CFA1xx: geometric single-assignment/coverage proofs over the facet
    family plus :func:`plan_accounting` on the (possibly injected) plan."""
    diags: list[Diagnostic] = []
    if _is_cfa_state(state):
        cand = state.candidate
        diags += check_facet_family(
            state.space, state.program.deps, Tiling(cand.tile),
            storage=state.storage, **_cfa_family_kwargs(cand),
        )
    p = plan if plan is not None else _plan_of(state)
    if p is not None:
        diags += plan_accounting(p)
    return diags


@analysis_pass("verify_overlap", codes=("CFA201", "CFA202"))
def verify_overlap(
    state: CompileState, *,
    waves: Sequence[Sequence[Sequence[int]]] | None = None,
) -> list[Diagnostic]:
    """CFA2xx: the wave schedule (default or injected) respects every tile
    dependence — the precondition of the dataflow backend's overlap."""
    if not _is_cfa_state(state):
        return []
    return check_overlap_schedule(state.space, state.program.deps,
                                  Tiling(state.candidate.tile), waves=waves)


@analysis_pass("lint_bursts",
               codes=("CFA301", "CFA302", "CFA303", "CFA304"))
def lint_bursts(
    state: CompileState, *, plan: TransferPlan | None = None,
) -> list[Diagnostic]:
    """CFA3xx: :func:`lint_plan` under the bound target's burst model, with
    the expected-burst bound from ``cfa_piece_census`` when applicable."""
    p = plan if plan is not None else _plan_of(state)
    if p is None or state.target is None:
        return []
    model = getattr(state.target, "model", state.target)
    if not isinstance(model, BurstModel):
        return []
    contiguity = None
    expected = None
    if _is_cfa_state(state):
        cand = state.candidate
        contiguity = cand.contiguity or "intra-tile"
        if (contiguity == "intra-tile" and state.storage == "redundant"
                and p.scheme.startswith("cfa")
                and p.read_run_hosts is not None):
            # the §IV-H/I construction: one read burst per host facet, one
            # for the corner suffix, plus any §IV-J unmergeable pieces
            census = cfa_piece_census(
                state.space, state.program.deps, Tiling(cand.tile),
                ext_dirs=(dict(cand.ext_dirs)
                          if cand.ext_dirs is not None else None),
            )
            expected = (len(set(p.read_run_hosts)) + 1
                        + census["unmergeable"])
    return lint_plan(p, model, n_ports=state.n_ports, contiguity=contiguity,
                     expected_read_bursts=expected,
                     assignment=state.port_assignment)


@analysis_pass("verify_contracts",
               codes=("CFA401", "CFA402", "CFA403", "CFA404"))
def verify_contracts(state: CompileState) -> list[Diagnostic]:
    """CFA4xx: backend capabilities, overlap support, codec exactness
    preconditions and the platform port budget vs the lowered state."""
    diags: list[Diagnostic] = []
    ex = state.executor
    if ex is not None and hasattr(state.program, "deps"):
        from .executors import ineligible_reason

        reason = ineligible_reason(ex, state.program, state.space,
                                   state.n_ports, state.storage)
        if reason is not None:
            fix = ("storage" if "storage" in reason
                   else "n_ports" if "port" in reason else None)
            diags.append(Diagnostic(
                "CFA401", "ERROR",
                f"backend contract violated: {reason}",
                fixit=fix,
            ))
        if state.overlap and not ex.caps.overlap:
            diags.append(Diagnostic(
                "CFA402", "ERROR",
                f"overlap=True but backend {ex.name!r} runs fetch/compute/"
                f"commit sequentially — the Fig. 13 DATAFLOW schedule needs "
                f'backend="dataflow"',
            ))
    tgt = state.target
    max_ports = getattr(tgt, "max_ports", None)
    if max_ports is not None and state.n_ports > max_ports:
        diags.append(Diagnostic(
            "CFA404", "ERROR",
            f"n_ports={state.n_ports} exceeds target "
            f"{getattr(tgt, 'name', tgt)!r}'s port budget of {max_ports}",
            fixit="n_ports",
        ))
    cdc = state.codec
    if cdc is not None and hasattr(cdc, "bits"):
        if state.storage != "compressed":
            diags.append(Diagnostic(
                "CFA403", "ERROR",
                f"codec {cdc.name!r} bound under storage="
                f"{state.storage!r} — a block codec only applies to the "
                f"compressed discipline",
                fixit="storage",
            ))
        elif cdc.bits:
            diags.append(Diagnostic(
                "CFA403", "INFO",
                f"codec {cdc.name!r} keeps {cdc.bits}-bit residuals: exact "
                f"only where BlockCodec.exact holds per block; other data "
                f"is quantised on commit",
            ))
    return diags


#: The default analysis suite, in severity-of-subject order: correctness
#: proofs first, then the schedule, then the priced lints, then contracts.
DEFAULT_ANALYSES: tuple[AnalysisPass, ...] = (
    verify_single_assignment,
    verify_overlap,
    lint_bursts,
    verify_contracts,
)


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------


def run_analyses(
    state: CompileState,
    analyses: Sequence[AnalysisPass] | None = None,
    *,
    plan: TransferPlan | None = None,
    waves: Sequence[Sequence[Sequence[int]]] | None = None,
) -> AnalysisReport:
    """Run ``analyses`` (default :data:`DEFAULT_ANALYSES`) over ``state``
    and collect the report.  ``plan``/``waves`` substitute corrupted
    artifacts — the mutation-testing hooks."""
    suite = DEFAULT_ANALYSES if analyses is None else tuple(analyses)
    overrides = {k: v for k, v in (("plan", plan), ("waves", waves))
                 if v is not None}
    diags: list[Diagnostic] = []
    for a in suite:
        diags.extend(a.diagnose(state, **overrides))
    return AnalysisReport(tuple(diags),
                          analyses=tuple((a.name, a.version) for a in suite))


def _state_of(compiled) -> CompileState:
    """Reconstruct the post-lowering ``CompileState`` a ``CompiledStencil``
    came from — what :func:`verify` feeds the analysis passes."""
    return CompileState(
        program=compiled.program,
        space=compiled.space,
        target=compiled.target,
        n_ports=compiled.n_ports,
        layout=compiled.layout,
        backend=compiled.backend,
        storage=compiled.storage,
        codec=compiled.codec,
        overlap=compiled.executor.caps.overlap,
        candidate=compiled.layout,
        decision=compiled.decision,
        storage_map=compiled.storage_map,
        port_assignment=getattr(compiled.pipeline, "port_assignment", None),
        executor=compiled.executor,
        pipeline=compiled.pipeline,
        compiled=compiled,
        distributed=compiled.distributed,
        device=compiled.device,
    )


def verify(
    compiled,
    *,
    analyses: Sequence[AnalysisPass] | None = None,
    plan: TransferPlan | None = None,
    waves: Sequence[Sequence[Sequence[int]]] | None = None,
    strict: bool = False,
    raise_on_error: bool = True,
) -> AnalysisReport:
    """Statically verify a :class:`~repro_torch.core.cfa.api.CompiledStencil`.

    Runs the analysis suite over the stencil's reconstructed compile state
    and returns the :class:`AnalysisReport`.  With ``raise_on_error``
    (default) a report containing ERROR diagnostics — or WARN too, under
    ``strict`` — raises :class:`VerificationError` carrying the report.
    ``plan``/``waves`` substitute a corrupted transfer plan or wave
    schedule for the compiled one (mutation testing / what-if audits).

        compiled = cfa.compile("jacobi2d5p", (32, 32, 32))
        report = cfa.verify(compiled)          # raises on ERROR
        report = cfa.verify(compiled, raise_on_error=False)
        print(report.summary())
    """
    report = run_analyses(_state_of(compiled), analyses, plan=plan,
                          waves=waves)
    if raise_on_error and (report.errors or (strict and report.warnings)):
        raise VerificationError(report, strict=strict)
    return report


def verify_pipeline(base=None):
    """A :class:`~repro_torch.core.cfa.passes.PassPipeline` extending ``base``
    (default: the default lowering) with :data:`DEFAULT_ANALYSES` — what
    ``cfa.compile(..., verify=True)`` lowers with.  Analysis passes already
    present in ``base`` are not duplicated."""
    from .passes import PassPipeline, default_pipeline

    base = default_pipeline() if base is None else base
    extra = tuple(a for a in DEFAULT_ANALYSES if a.name not in base.names)
    if not extra:
        return base
    return PassPipeline(tuple(base.passes) + extra)
