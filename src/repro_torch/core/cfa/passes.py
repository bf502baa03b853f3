"""Pass-pipeline lowering: ``cfa.compile`` as staged, inspectable passes.

The paper frames the burst-friendly layout as a *source-to-source compiler
pass*; Iris (Soldavini et al., 2022) shows automatic layout generation
structured as a staged compiler flow.  This module makes our lowering that
shape: an immutable :class:`CompileState` artifact flows through a
:class:`PassPipeline` of small, individually-testable passes, each refining
one aspect of the compilation —

    resolve_program   programs/spaces/storage knobs -> concrete objects
    validate_target   platform registry lookup + port-budget gate
    distribute        split an over-budget space across the port mesh
    layout_search     autotune / explicit layout -> LayoutCandidate
    storage_map       the irredundant ownership map (Ferry 2024)
    port_repartition  compile-time facet -> port assignment (§VII)
    select_backend    the ExecutorCaps capability gate
    lower_backend     build the CFAPipeline + CompiledStencil

``cfa.compile`` (:mod:`repro_torch.core.cfa.api`) is a thin driver over
:func:`default_pipeline`; the result is bit-exact and API-compatible with
the pre-pipeline monolith.  Every run records a per-pass trace — name,
version, wall time, and a summary of the state fields the pass changed —
surfaced as ``CompiledStencil.trace()``.

The pipeline validates its own shape at assembly time: duplicate pass
names, a stage whose declared ``requires`` no earlier stage provides, or a
pipeline that never provides ``"compiled"`` are all rejected loudly with
:class:`PipelineError` — a silently re-ordered lowering must not run.  The
ordered (name, version) list is the *pipeline fingerprint*
(:func:`default_pass_fingerprint`); the autotune cache folds it into its
key and its stored decisions (schema v7), so editing or re-ordering the
lowering invalidates cached layout decisions loudly instead of silently
serving stale ones.

This is the reference package's lowering, copied: the same passes, names
and versions.  ``select_backend`` and ``lower_backend`` use the port's
executor registry and its PyTorch ``CFAPipeline``, built on the state's
``device``.  The ``distribute`` pass still computes its split, but no
backend of the port runs ``n_ports > 1`` yet (the sharded slice), so an
over-budget space is rejected by the backend gate; ``lower_backend``
rejects non-redundant storage and ``halo_quantize=True`` until their
slices land.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Mapping, Protocol, Sequence, runtime_checkable

from .autotune import LayoutCandidate, LayoutDecision, autotune
from .compress import BlockCodec, get_codec
from .facets import build_facet_specs
from .irredundant import STORAGE_MODES, StorageMap, build_storage_map
from .multiport import PortAssignment, assign_ports
from .programs import StencilProgram, get_program
from .spaces import IterSpace, Tiling

__all__ = [
    "CompileState",
    "Pass",
    "PassPipeline",
    "PassTrace",
    "PipelineError",
    "default_pipeline",
    "default_pass_fingerprint",
    "estimate_facet_bytes",
    "DEFAULT_PASSES",
]


class PipelineError(ValueError):
    """A malformed pass pipeline: duplicate, missing or mis-ordered stages."""


# --------------------------------------------------------------------------
# The artifact
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CompileState:
    """The immutable lowering artifact: request fields in, artifacts accreted.

    The request fields (``program`` .. ``halo_quantize``) mirror
    ``cfa.compile``'s signature and are *refined in place* — after
    ``resolve_program``/``validate_target`` they hold concrete
    ``StencilProgram``/``IterSpace``/``Target`` objects.  The artifact
    fields start ``None`` and accrete per stage; ``compiled`` is the final
    product.  Passes never mutate: each returns a new state via
    ``dataclasses.replace``.
    """

    # -- request ------------------------------------------------------------
    program: Any  # StencilProgram | str -> StencilProgram
    space: Any  # IterSpace | Sequence[int] -> IterSpace
    target: Any = None  # Target | BurstModel | str -> Target
    n_ports: int = 1
    layout: Any = "autotune"
    backend: str = "auto"  # -> resolved executor name
    storage: str = "redundant"
    codec: Any = None  # BlockCodec | str | None -> BlockCodec | None
    overlap: bool = False
    autotune_kwargs: Mapping | None = None
    # the distribute pass: per-host facet-memory budget in bytes (None =
    # single-host, never split) and the optional int8 halo-traffic hook
    host_budget: int | None = None
    halo_quantize: bool = False
    # the torch device the lowered pipeline runs on
    device: Any = "cuda"

    # -- artifacts (accreted per stage) --------------------------------------
    candidate: LayoutCandidate | None = None
    decision: LayoutDecision | None = dataclasses.field(default=None, repr=False)
    storage_map: StorageMap | None = dataclasses.field(default=None, repr=False)
    port_assignment: PortAssignment | None = None
    executor: Any = None  # Executor
    pipeline: Any = None  # CFAPipeline
    compiled: Any = None  # CompiledStencil
    distributed: bool = False
    # analysis passes (repro_torch.core.cfa.analysis) append Diagnostic records
    # here; lowering passes never touch it
    diagnostics: tuple = ()
    # bookkeeping (excluded from trace diffs): the running pipeline's
    # fingerprint (seeded by PassPipeline.run) and the accreted trace
    pass_fingerprint: tuple = dataclasses.field(default=None, repr=False, compare=False)
    trace: tuple = dataclasses.field(default=(), repr=False, compare=False)


_UNTRACED_FIELDS = ("trace", "pass_fingerprint")


# --------------------------------------------------------------------------
# Pass protocol + trace
# --------------------------------------------------------------------------


@runtime_checkable
class Pass(Protocol):
    """One lowering stage: ``run`` maps a CompileState to a refined one.

    ``requires``/``provides`` declare abstract artifact tokens (e.g.
    ``"layout"``, ``"backend"``) used by :class:`PassPipeline` to validate
    stage order at assembly time; ``(name, version)`` pairs form the
    pipeline fingerprint the autotune cache is keyed by.
    """

    name: str
    version: str
    requires: tuple[str, ...]
    provides: tuple[str, ...]

    def run(self, state: CompileState) -> CompileState: ...


@dataclasses.dataclass(frozen=True)
class PassTrace:
    """One pass's trace record: identity, wall time, and the artifact diff
    (state fields the pass changed, each with a short human summary)."""

    name: str
    version: str
    wall_s: float
    changed: tuple[tuple[str, str], ...]  # (field, summary of new value)

    def to_dict(self) -> dict:
        return {
            "pass": self.name,
            "version": self.version,
            "wall_s": self.wall_s,
            "changed": dict(self.changed),
        }


@dataclasses.dataclass(frozen=True)
class _FnPass:
    """A Pass wrapping a plain function (the built-in stages)."""

    name: str
    version: str
    requires: tuple[str, ...]
    provides: tuple[str, ...]
    fn: Callable[[CompileState], CompileState] = dataclasses.field(compare=False)

    def run(self, state: CompileState) -> CompileState:
        return self.fn(state)


def compiler_pass(
    name: str,
    version: str = "1",
    *,
    requires: Sequence[str] = (),
    provides: Sequence[str] = (),
):
    """Decorator turning ``fn(state) -> state`` into a registered Pass."""

    def deco(fn: Callable[[CompileState], CompileState]) -> _FnPass:
        return _FnPass(name=name, version=version, requires=tuple(requires),
                       provides=tuple(provides), fn=fn)

    return deco


def _summarize(v: Any) -> str:
    """A one-line human summary of an artifact value (for trace diffs)."""
    if v is None:
        return "None"
    if isinstance(v, (bool, int, float, str)):
        return repr(v)
    kind = type(v).__name__
    if isinstance(v, StencilProgram):
        return f"{v.name} ({v.ndim}-D)"
    if isinstance(v, IterSpace):
        return f"space {v.sizes}"
    if isinstance(v, LayoutCandidate):
        return v.key
    if isinstance(v, LayoutDecision):
        tail = " [cache]" if v.from_cache else ""
        return f"{v.evaluated} candidates -> {v.best.candidate.key}{tail}"
    if isinstance(v, StorageMap):
        return f"stored {v.stored_elems} elems (saves {v.savings:.1%})"
    if isinstance(v, PortAssignment):
        return (f"{v.n_ports} ports, facets "
                f"{dict(sorted(v.facet_to_port.items()))}")
    if isinstance(v, BlockCodec):
        return f"codec {v.name}"
    if hasattr(v, "caps") and hasattr(v, "name"):  # an Executor
        return f"executor {v.name}"
    if hasattr(v, "model") and hasattr(v, "max_ports"):  # a Target
        return f"target {v.name} (max_ports={v.max_ports})"
    if hasattr(v, "tiling") and hasattr(v, "specs"):  # a CFAPipeline
        return f"{kind}(tile={v.tiling.sizes})"
    if hasattr(v, "executor") and hasattr(v, "layout"):  # a CompiledStencil
        return f"backend {v.backend}, layout {v.layout.key}"
    if (isinstance(v, tuple) and v
            and all(hasattr(d, "code") and hasattr(d, "severity") for d in v)):
        # a Diagnostic tuple (duck-typed: passes must not import analysis)
        by_sev = {s: sum(1 for d in v if d.severity == s)
                  for s in ("ERROR", "WARN", "INFO")}
        head = ", ".join(f"{s}={n}" for s, n in by_sev.items() if n)
        return f"{len(v)} diagnostic(s): {head}"
    if isinstance(v, tuple):
        return repr(v)
    return kind


def _diff(before: CompileState, after: CompileState) -> tuple[tuple[str, str], ...]:
    changed = []
    for f in dataclasses.fields(CompileState):
        if f.name in _UNTRACED_FIELDS:
            continue
        old, new = getattr(before, f.name), getattr(after, f.name)
        if old is not new and old != new:
            changed.append((f.name, _summarize(new)))
    return tuple(changed)


# --------------------------------------------------------------------------
# The runner
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PassPipeline:
    """An ordered sequence of passes, validated at assembly time.

    * duplicate pass names are rejected (a stage must not run twice);
    * every pass's declared ``requires`` must be provided by an earlier
      pass (so a missing or mis-ordered stage fails at construction, not
      mid-lowering);
    * the pipeline must end up providing ``"compiled"`` — a lowering that
      cannot produce a ``CompiledStencil`` is not a lowering.

    ``run`` threads a :class:`CompileState` through the stages, recording a
    :class:`PassTrace` per pass (also retrievable as :meth:`trace` after a
    run); ``fingerprint`` is the ordered (name, version) identity the
    autotune cache is keyed by (schema v7).
    """

    passes: tuple[Pass, ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "passes", tuple(self.passes))
        seen: set[str] = set()
        provided: set[str] = set()
        for p in self.passes:
            if p.name in seen:
                raise PipelineError(
                    f"duplicate pass {p.name!r}: each lowering stage runs "
                    f"exactly once"
                )
            seen.add(p.name)
            missing = [r for r in p.requires if r not in provided]
            if missing:
                raise PipelineError(
                    f"pass {p.name!r} requires {missing} but no earlier "
                    f"pass provides it — stage missing or mis-ordered "
                    f"(pipeline so far: {[q.name for q in self.passes if q.name in seen]})"
                )
            provided.update(p.provides)
        if "compiled" not in provided:
            raise PipelineError(
                f"pipeline {[p.name for p in self.passes]} never provides "
                f"'compiled' — a lower_backend stage is required"
            )

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(p.name for p in self.passes)

    def fingerprint(self) -> tuple[tuple[str, str], ...]:
        """The ordered (name, version) identity of this lowering."""
        return tuple((p.name, p.version) for p in self.passes)

    def without(self, name: str) -> "PassPipeline":
        """A new pipeline with the named stage removed (re-validated)."""
        if name not in self.names:
            raise PipelineError(f"no pass named {name!r} in {self.names}")
        return PassPipeline(tuple(p for p in self.passes if p.name != name))

    def replaced(self, name: str, new: Pass) -> "PassPipeline":
        """A new pipeline with the named stage swapped out (re-validated)."""
        if name not in self.names:
            raise PipelineError(f"no pass named {name!r} in {self.names}")
        return PassPipeline(tuple(
            new if p.name == name else p for p in self.passes
        ))

    def run(self, state: CompileState) -> CompileState:
        """Thread ``state`` through every stage, tracing each pass."""
        if state.pass_fingerprint is None:
            state = dataclasses.replace(state,
                                        pass_fingerprint=self.fingerprint())
        for p in self.passes:
            t0 = time.perf_counter()
            new = p.run(state)
            wall = time.perf_counter() - t0
            if not isinstance(new, CompileState):
                raise PipelineError(
                    f"pass {p.name!r} returned {type(new).__name__}, not a "
                    f"CompileState"
                )
            entry = PassTrace(name=p.name, version=p.version, wall_s=wall,
                              changed=_diff(state, new))
            state = dataclasses.replace(new, trace=new.trace + (entry,))
        object.__setattr__(self, "_last_trace", state.trace)
        return state

    def trace(self) -> tuple[PassTrace, ...]:
        """The per-pass trace of the most recent :meth:`run` (empty before)."""
        return getattr(self, "_last_trace", ())


# --------------------------------------------------------------------------
# The built-in stages
# --------------------------------------------------------------------------


@compiler_pass("resolve_program", provides=("program",))
def resolve_program(state: CompileState) -> CompileState:
    """Resolve program/space names to objects; validate the storage knobs."""
    prog = (get_program(state.program) if isinstance(state.program, str)
            else state.program)
    sp = (state.space if isinstance(state.space, IterSpace)
          else IterSpace(tuple(state.space)))
    if prog.ndim != sp.ndim:
        raise ValueError(
            f"program {prog.name!r} is {prog.ndim}-D but the space "
            f"{sp.sizes} is {sp.ndim}-D"
        )
    if state.storage not in STORAGE_MODES:
        raise ValueError(
            f"storage must be one of {STORAGE_MODES}: {state.storage!r}"
        )
    if state.codec is not None and state.storage != "compressed":
        raise ValueError(
            f'a codec only applies to storage="compressed", not '
            f'{state.storage!r}'
        )
    cdc = get_codec(state.codec) if state.storage == "compressed" else None
    return dataclasses.replace(state, program=prog, space=sp, codec=cdc)


@compiler_pass("validate_target", requires=("program",), provides=("target",))
def validate_target(state: CompileState) -> CompileState:
    """Resolve the target and gate ``n_ports`` against its port budget."""
    from .api import get_target

    # a hand-built CompileState may leave target unset; resolve it to the
    # same platform compile() defaults to
    tgt = get_target(state.target if state.target is not None
                     else "axi-zc706")
    if state.n_ports < 1:
        raise ValueError(f"n_ports must be >= 1: {state.n_ports}")
    if tgt.max_ports is not None and state.n_ports > tgt.max_ports:
        raise ValueError(
            f"target {tgt.name!r} has {tgt.max_ports} memory port(s); "
            f"n_ports={state.n_ports} exceeds the platform budget"
        )
    return dataclasses.replace(state, target=tgt)


def estimate_facet_bytes(
    program: StencilProgram,
    space: IterSpace,
    *,
    tile: Sequence[int] | None = None,
    elem_bytes: int = 4,
) -> int:
    """Estimated bytes of the whole facet family for ``program`` on
    ``space`` — the distribute pass's budget metric.

    Facet ``k`` stores ``w_k`` planes per tile (``num_tiles x w_k x
    prod_{a != k} t_a`` elements), so the total depends mildly on the
    tiling; budget decisions are made against the program's default tile
    (clipped to the space) unless ``tile`` overrides — the layout search
    runs *after* distribution, so the exact tile is not yet known.
    """
    N = space.sizes
    t = tuple(tile) if tile is not None else program.default_tile
    t = tuple(max(1, min(int(ta), int(na))) for ta, na in zip(t, N))
    num_tiles = math.prod(-(-na // ta) for na, ta in zip(N, t))
    total = 0
    for k, wk in enumerate(program.widths):
        if wk <= 0:
            continue
        block = wk * math.prod(ta for a, ta in enumerate(t) if a != k)
        total += num_tiles * block
    return total * elem_bytes


@compiler_pass("distribute", requires=("program", "target"),
               provides=("distribution",))
def distribute(state: CompileState) -> CompileState:
    """Split an over-budget space across the port mesh.

    With no ``host_budget`` this is a no-op (single-host lowering).  When
    the estimated facet bytes exceed the budget, the space is split over
    ``ceil(estimate / budget)`` ports — each port's device then holds only
    its assigned facet arrays (``shard_facets``), so per-host residency
    fits the budget — and ``n_ports`` is raised accordingly; backend
    auto-selection lowers the result to the sharded executor.  A budget so
    small that even the target's full port complement cannot satisfy it is
    rejected loudly.
    """
    if state.host_budget is None:
        return state
    if state.host_budget <= 0:
        raise ValueError(
            f"host_budget must be positive bytes: {state.host_budget}"
        )
    est = estimate_facet_bytes(state.program, state.space,
                               elem_bytes=state.target.model.elem_bytes)
    if est <= state.host_budget:
        return state
    shards = -(-est // state.host_budget)
    ports = max(state.n_ports, int(shards))
    if state.target.max_ports is not None and ports > state.target.max_ports:
        raise ValueError(
            f"space {state.space.sizes} needs ~{est} B of facet storage = "
            f"{int(shards)} shard(s) under the {state.host_budget} B/host "
            f"budget, but target {state.target.name!r} offers only "
            f"{state.target.max_ports} port(s); raise host_budget or pick "
            f"a target with more ports"
        )
    return dataclasses.replace(state, n_ports=ports, distributed=True)


@compiler_pass("layout_search", requires=("program", "target"),
               provides=("layout",))
def layout_search(state: CompileState) -> CompileState:
    """Resolve the layout request to a CFA candidate (autotune wrapped).

    ``"autotune"`` runs the staged search (co-tuned with the — possibly
    distribute-raised — port count and scored under the requested storage
    discipline), forwarding the running pipeline's fingerprint so cached
    decisions are keyed by the lowering that produced them (schema v7).
    """
    layout = state.layout
    cand: LayoutCandidate
    decision: LayoutDecision | None
    if isinstance(layout, str):
        if layout == "autotune":
            kwargs = dict(state.autotune_kwargs or {})
            kwargs.setdefault("pass_fingerprint", state.pass_fingerprint)
            decision = autotune(state.program, state.space,
                                state.target.model, n_ports=state.n_ports,
                                storage=state.storage, codec=state.codec,
                                **kwargs)
            cand = decision.best_cfa().candidate
        elif layout == "default":
            cand, decision = LayoutCandidate(
                "cfa", state.program.default_tile, contiguity="intra-tile",
            ), None
        else:
            raise ValueError(
                f"layout must be 'autotune', 'default', a LayoutCandidate, "
                f"a LayoutDecision or a tile tuple; got {layout!r}"
            )
    elif isinstance(layout, LayoutCandidate):
        if layout.scheme != "cfa":
            raise ValueError(
                f"only 'cfa'-scheme layouts are executable (facet storage); "
                f"got scheme {layout.scheme!r} — the baseline schemes exist "
                f"for plan/bandwidth comparison only"
            )
        cand, decision = layout, None
    elif isinstance(layout, LayoutDecision):
        if (layout.program != state.program.name
                or tuple(layout.space) != state.space.sizes):
            raise ValueError(
                f"decision is for {layout.program!r} @ {tuple(layout.space)}, "
                f"not {state.program.name!r} @ {state.space.sizes}"
            )
        cand, decision = layout.best_cfa().candidate, layout
    elif isinstance(layout, Sequence):
        cand, decision = LayoutCandidate(
            "cfa", tuple(int(t) for t in layout), contiguity="intra-tile",
        ), None
    else:
        raise TypeError(f"cannot interpret layout {layout!r}")
    return dataclasses.replace(state, candidate=cand, decision=decision)


@compiler_pass("storage_map", requires=("program", "layout"),
               provides=("storage_map",))
def storage_map(state: CompileState) -> CompileState:
    """Compute the irredundant ownership map (None under redundant storage).

    The map is a pure function of the facet family, exposed here as an
    inspectable artifact; the lowered Irredundant/Compressed pipeline
    recomputes the identical map from the same specs.
    """
    if state.storage == "redundant":
        return state
    cand = state.candidate
    specs = build_facet_specs(
        state.space, state.program.deps, Tiling(cand.tile),
        ext_dirs=dict(cand.ext_dirs) if cand.ext_dirs is not None else None,
        contiguity=cand.contiguity or "intra-tile",
    )
    return dataclasses.replace(state, storage_map=build_storage_map(specs))


@compiler_pass("port_repartition", requires=("program", "layout"),
               provides=("ports",))
def port_repartition(state: CompileState) -> CompileState:
    """Fix the facet -> port split at compile time (§VII).

    Reuses the autotune decision's winning assignment when it was computed
    for this exact port count and tile; otherwise the LPT split of
    ``multiport.assign_ports``.  Single-port lowerings carry no assignment.
    """
    if state.n_ports <= 1:
        return state
    assignment = None
    d = state.decision
    if d is not None and getattr(d, "n_ports", 1) == state.n_ports:
        try:
            best = d.best_cfa()
        except LookupError:
            best = None
        if (best is not None
                and tuple(best.candidate.tile) == tuple(state.candidate.tile)):
            assignment = d.port_assignment  # may still be None (burst-granular)
    if assignment is None:
        assignment = assign_ports(state.space, state.program.deps,
                                  Tiling(state.candidate.tile), state.n_ports)
    return dataclasses.replace(state, port_assignment=assignment)


@compiler_pass("select_backend", requires=("program", "target"),
               provides=("backend",))
def select_backend(state: CompileState) -> CompileState:
    """Resolve ``backend="auto"`` and gate against declared capabilities."""
    from . import executors

    name = (executors.select_backend(state.program, state.space,
                                     state.n_ports, state.storage,
                                     state.overlap)
            if state.backend == "auto" else state.backend)
    ex = executors.get_executor(name)
    executors.check_backend(ex, state.program, state.space, state.n_ports,
                            state.storage)
    if state.overlap and not ex.caps.overlap:
        raise executors.BackendError(
            f"overlap=True needs a backend that pipelines fetch/compute/"
            f"commit, but {name!r} runs its phases sequentially; use "
            f'backend="dataflow" (or "auto")'
        )
    return dataclasses.replace(state, backend=name, executor=ex)


@compiler_pass("lower_backend",
               requires=("program", "target", "layout", "backend"),
               provides=("compiled",))
def lower_backend(state: CompileState) -> CompileState:
    """Instantiate the CFAPipeline on the requested device and wrap it with
    the bound executor into the final ``CompiledStencil``.

    The port's pipelines realise the paper's redundant storage without
    halo quantization; the other disciplines and the int8 halo hook arrive
    with later slices and are rejected here, loudly."""
    from .api import CompiledStencil
    from .transform import CFAPipeline

    if state.storage != "redundant":
        raise NotImplementedError(
            f"storage={state.storage!r}: the PyTorch port lowers only the "
            f"redundant facet layout yet (irredundant/compressed storage is "
            f"the storage slice)"
        )
    if state.halo_quantize:
        raise NotImplementedError(
            "halo_quantize=True: the PyTorch port has no int8 halo hook yet "
            "(it arrives with the multi-port slice)"
        )
    cand = state.candidate
    pipeline = CFAPipeline(
        state.program, state.space, Tiling(cand.tile),
        ext_dirs=cand.ext_dirs,
        contiguity=cand.contiguity or "intra-tile",
        decision=state.decision,
        port_assignment=state.port_assignment,
        device=state.device,
    )
    compiled = CompiledStencil(
        program=state.program, space=state.space, target=state.target,
        n_ports=state.n_ports, executor=state.executor, pipeline=pipeline,
        layout=cand, decision=state.decision, storage=state.storage,
        codec=state.codec, distributed=state.distributed,
    )
    return dataclasses.replace(state, pipeline=pipeline, compiled=compiled)


# --------------------------------------------------------------------------
# The default lowering
# --------------------------------------------------------------------------

#: the pinned default pass surface, in lowering order
DEFAULT_PASSES: tuple[Pass, ...] = (
    resolve_program,
    validate_target,
    distribute,
    layout_search,
    storage_map,
    port_repartition,
    select_backend,
    lower_backend,
)


def default_pipeline() -> PassPipeline:
    """A fresh instance of the default lowering pipeline."""
    return PassPipeline(DEFAULT_PASSES)


def default_pass_fingerprint() -> tuple[tuple[str, str], ...]:
    """The default pipeline's ordered (name, version) fingerprint — the
    identity the autotune cache folds into its key (schema v7)."""
    return tuple((p.name, p.version) for p in DEFAULT_PASSES)
