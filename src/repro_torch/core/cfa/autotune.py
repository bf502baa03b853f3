"""Layout autotuner: search the CFA layout family for the fastest layout.

The paper evaluates *one* layout per benchmark — the final CFA family with
cyclic extension directions, intra-tile contiguity, and a hand-picked tile
size (Table I).  Iris (Soldavini et al., 2022) and the irredundant-layout
follow-up (Ferry et al., 2024) both show the real bandwidth wins come from
*searching* the layout space per workload.  This module is that search:

    given   a StencilProgram, an IterSpace and a BurstModel,
    explore  candidate Tilings x extension-direction assignments x
             contiguity levels (full-tile / inter-tile / intra-tile, §IV-G/H/I)
             x port repartitions (``n_ports > 1``, §VII future work),
             plus the paper's three baselines as hand-coded seeds,
    score    each candidate's interior-tile TransferPlan under the BurstModel
             (modeled effective bandwidth = useful bytes / modeled time; with
             ``n_ports > 1`` the time is the slowest port's after the best
             ``multiport`` repartition, so layout and repartition co-tune),
    return   a ranked LayoutDecision (carrying the winning port assignment).

The hand-coded plans (``cfa_plan`` at the program's default tile,
``original_layout_plan``, ``bounding_box_plan``, ``data_tiling_plan``) are
always seeded into the candidate set, so the decision's best candidate scores
at least as well as every baseline by construction.

Decisions are memoised in a persistent on-disk cache keyed by
(program, space, model, search parameters) so repeated runs are free.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import math
import os
import tempfile
import warnings
from pathlib import Path
from typing import Sequence

import numpy as np

from .bandwidth import AXI_ZC706, BandwidthReport, BurstModel, PortedPlan
from .compress import get_codec
from .facets import CONTIGUITY_LEVELS, extension_dir
from .irredundant import STORAGE_MODES
from .multiport import PORT_STRATEGIES, PortAssignment, best_repartition
from .plans import (
    TransferPlan,
    bounding_box_plan,
    cfa_plan,
    data_tiling_plan,
    interior_tile,
    original_layout_plan,
)
from .programs import StencilProgram, get_program
from .spaces import IterSpace, Tiling

__all__ = [
    "LayoutCandidate",
    "ScoredLayout",
    "LayoutDecision",
    "CacheSchemaError",
    "SCORE_MODES",
    "autotune",
    "candidate_tilings",
    "hand_coded_baselines",
    "default_cache_dir",
    "clear_cache",
]

# v7: the pass-pipeline fingerprint (repro_torch.core.cfa.passes) — the ordered
# (pass name, version) list of the lowering that ran the search is folded
# into the cache key AND stored on the decision (``pass_pipeline``), and
# the loader rejects a fingerprint mismatch loudly: a decision computed by
# one lowering (e.g. before a pass was reordered, added or re-versioned)
# must not silently drive another.
# v6: the dataflow overlap axis (Fig. 13 DATAFLOW, ``backend="dataflow"``)
# — decision-level ``overlap`` + ``compute_per_elem_s`` knobs, per-candidate
# overlap/compute_s fields on ScoredLayout (time_s becomes the overlapped
# tile time when enabled), both folded into the cache key; the executor
# capability fingerprint also grew the per-backend overlap flag.
# v5: the score axis (modeled / measured wall-clock ranking, see
# ``calibrate``) — decision-level ``score``, per-candidate
# measured_time_s/model_error on ScoredLayout, score + host fingerprint +
# measurement fidelity folded into the cache key, and a loud score-mismatch
# rejection in the cache loader so modeled- and measured-scored decisions
# can never be interchanged.
# v4: storage axis (redundant / irredundant / compressed facet storage,
# Ferry 2024) — per-candidate footprint/stored_elems/codec_bits fields on
# ScoredLayout, decision-level storage + footprint_weight, and both folded
# into the cache key.
# v3: the cache key folds in the registered executor-backend capability
# set (next to the target model identity it already carried), so decisions
# re-search when the backend envelope changes; older schemas are rejected
# loudly (CacheSchemaError -> warning) instead of silently deserializing.
# v2: n_ports search dimension + per-candidate port fields (ScoredLayout)
# and the decision-level n_ports.
_CACHE_VERSION = 7

# how a candidate's rank is scored: by the analytic BurstModel, or by
# measured wall-clock of the top modeled candidates (calibrate.measure_plan)
SCORE_MODES = ("modeled", "measured")


class CacheSchemaError(ValueError):
    """An on-disk autotune decision uses a different cache schema version."""


# --------------------------------------------------------------------------
# Candidates
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayoutCandidate:
    """One point of the layout search space.

    ``scheme`` is one of ``cfa`` (the paper's facet family), ``original``
    (Bayliss [16]), ``bbox`` (Pouchet [8]) or ``data-tiling`` (Ozturk [19]).
    ``ext_dirs``/``contiguity`` parameterise the CFA family (§IV-H/I);
    ``block`` parameterises data tiling.
    """

    scheme: str
    tile: tuple[int, ...]
    ext_dirs: tuple[tuple[int, int], ...] | None = None  # (facet axis, c_k)
    contiguity: str | None = None
    block: tuple[int, ...] | None = None

    @property
    def key(self) -> str:
        """Canonical, deterministic identity string (also the rank tiebreak)."""
        parts = [self.scheme, "x".join(map(str, self.tile))]
        if self.ext_dirs is not None:
            parts.append("e" + ",".join(f"{k}:{c}" for k, c in self.ext_dirs))
        if self.contiguity is not None:
            parts.append(self.contiguity)
        if self.block is not None:
            parts.append("b" + "x".join(map(str, self.block)))
        return "/".join(parts)

    def plan(self, space: IterSpace, program: StencilProgram, *,
             storage: str = "redundant", codec=None) -> TransferPlan:
        """The candidate's interior-tile transfer plan.

        ``storage``/``codec`` select the facet storage discipline for CFA
        candidates (``cfa_plan``); the single-array baselines keep their own
        (duplicate-free by construction) storage accounting.
        """
        tiling = Tiling(self.tile)
        tile = interior_tile(space, tiling)
        if self.scheme == "cfa":
            return cfa_plan(
                space,
                program.deps,
                tiling,
                tile,
                ext_dirs=dict(self.ext_dirs) if self.ext_dirs is not None else None,
                contiguity=self.contiguity or "intra-tile",
                storage=storage,
                codec=codec if storage == "compressed" else None,
            )
        if self.scheme == "original":
            return original_layout_plan(space, program.deps, tiling, tile)
        if self.scheme == "bbox":
            return bounding_box_plan(space, program.deps, tiling, tile)
        if self.scheme == "data-tiling":
            return data_tiling_plan(space, program.deps, tiling, tile, block=self.block)
        raise ValueError(f"unknown layout scheme {self.scheme!r}")

    def is_default_cfa_layout(self, ndim: int) -> bool:
        """True iff this is the paper's final layout family (the only one the
        ``facet_fetch`` Pallas kernel's BlockSpecs hard-code)."""
        if self.scheme != "cfa" or (self.contiguity or "intra-tile") != "intra-tile":
            return False
        if self.ext_dirs is None:
            return True
        return all(c == extension_dir(k, ndim) for k, c in self.ext_dirs)


@dataclasses.dataclass(frozen=True)
class ScoredLayout:
    """A candidate plus its BurstModel score (per interior tile).

    With ``n_ports > 1`` the *time and bandwidth* figures describe the
    candidate after its best port repartition: ``time_s`` is the slowest
    port's time (ports run concurrently), ``raw_bw``/``effective_bw`` are
    aggregate across ports, and ``port_strategy``/``port_assignment``/
    ``port_balance``/``port_speedup_vs_single`` record how the repartition
    was realised (assignment is ``None`` for burst-granular strategies,
    which split below facet granularity).  The *layout* figures —
    ``n_read_bursts``/``n_write_bursts``/``transferred``/``useful``/
    ``redundancy`` — always describe the underlying single-port plan (a
    ``stripe`` split issues more, shorter bursts; that cost is reflected in
    ``time_s``, not re-counted here).
    """

    candidate: LayoutCandidate
    n_read_bursts: int
    n_write_bursts: int
    transferred: int  # elements moved (incl. redundancy)
    useful: int  # elements actually needed
    redundancy: float
    time_s: float  # modeled transfer time for one interior tile
    raw_bw: float
    effective_bw: float  # useful bytes / modeled time — the ranking metric
    peak_fraction_effective: float
    n_ports: int = 1
    port_strategy: str | None = None
    port_assignment: tuple[tuple[int, int], ...] | None = None  # facet -> port
    port_balance: float | None = None
    port_speedup_vs_single: float | None = None
    # storage axis (schema v4): discipline, whole-layout stored elements,
    # per-tile stored slots, fixed-ratio compression width
    storage: str = "redundant"
    footprint: int | None = None
    stored_elems: int | None = None
    codec_bits: int | None = None
    # measured scoring (schema v5): wall-clock of this candidate's plan on
    # this host and the modeled time's relative error against it; filled
    # for the measured top candidates of an autotune(score="measured") run
    measured_time_s: float | None = None
    model_error: float | None = None
    # dataflow axis (schema v6): the per-tile compute seconds folded into
    # time_s, and whether the transfer was overlapped with it (Fig. 13
    # DATAFLOW — the schedule backend="dataflow" runs)
    overlap: bool = False
    compute_s: float = 0.0

    @property
    def n_bursts(self) -> int:
        return self.n_read_bursts + self.n_write_bursts

    @staticmethod
    def from_plan(
        candidate: LayoutCandidate,
        plan: TransferPlan,
        model: BurstModel,
        *,
        n_ports: int = 1,
        port_strategies: Sequence[str] = PORT_STRATEGIES,
        overlap: bool = False,
        compute_s: float = 0.0,
    ) -> "ScoredLayout":
        tkw = dict(compute_s=compute_s, overlap=overlap)
        t = t_single = model.time(plan, **tkw)
        ports: dict = {}
        scored_plan: TransferPlan | PortedPlan = plan
        if n_ports > 1:
            pp = best_repartition(plan, n_ports, model, port_strategies,
                                  **tkw)
            t = model.time(pp, **tkw)
            scored_plan = pp
            ports = dict(
                n_ports=n_ports,
                port_strategy=pp.strategy,
                port_assignment=pp.facet_to_port,
                port_balance=pp.balance,
                port_speedup_vs_single=t_single / t if t else 1.0,
            )
        rep = BandwidthReport.evaluate(scored_plan, model, **tkw)
        return ScoredLayout(
            overlap=overlap,
            compute_s=compute_s,
            candidate=candidate,
            n_read_bursts=plan.n_read_bursts,
            n_write_bursts=plan.n_write_bursts,
            transferred=plan.transferred,
            useful=plan.useful,
            redundancy=plan.redundancy,
            time_s=t,
            raw_bw=rep.raw_bw,
            effective_bw=rep.effective_bw,
            peak_fraction_effective=rep.peak_fraction_effective,
            storage=plan.storage,
            footprint=plan.footprint,
            stored_elems=plan.stored_elems,
            codec_bits=plan.codec_bits,
            **ports,
        )


def _rank_key(s: ScoredLayout, footprint_weight: float = 0.0) -> tuple:
    # Highest effective bandwidth first; deterministic tiebreaks.  With a
    # footprint weight the objective becomes bandwidth per stored element
    # (to the ``footprint_weight`` power): weight 0 ranks purely by speed,
    # weight 1 by effective bytes/s per slot the layout keeps resident —
    # the footprint axis of the trade-off curve.
    # Measured candidates (score="measured", schema v5) outrank unmeasured
    # ones and sort by their wall-clock; in a modeled decision no candidate
    # carries a measurement, so the leading pair is constant and the order
    # is the pure-model ranking below.
    eff = s.effective_bw
    if footprint_weight and s.footprint:
        eff = eff / (s.footprint ** footprint_weight)
    measured = (0, s.measured_time_s) if s.measured_time_s is not None else (1, 0.0)
    return (*measured, -eff, s.n_bursts, s.redundancy, s.candidate.key)


# --------------------------------------------------------------------------
# Decision
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayoutDecision:
    """Ranked outcome of one autotuning run (JSON round-trippable)."""

    program: str
    space: tuple[int, ...]
    widths: tuple[int, ...]
    model: str
    seed: int
    budget: int
    evaluated: int
    ranked: tuple[ScoredLayout, ...]  # best first
    n_ports: int = 1
    storage: str = "redundant"  # facet storage discipline searched under
    codec: str | None = None  # block codec name (storage="compressed" only)
    footprint_weight: float = 0.0  # footprint exponent in the ranking
    score: str = "modeled"  # ranking basis: analytic model or measured clock
    # dataflow axis (schema v6): rank by the overlapped tile time with this
    # much compute per tile element (seconds)
    overlap: bool = False
    compute_per_elem_s: float = 0.0
    # pass-pipeline axis (schema v7): the ordered (name, version)
    # fingerprint of the lowering pipeline this decision was searched for
    pass_pipeline: tuple[tuple[str, str], ...] | None = None
    from_cache: bool = dataclasses.field(default=False, compare=False)

    @property
    def best(self) -> ScoredLayout:
        return self.ranked[0]

    @property
    def port_assignment(self) -> PortAssignment | None:
        """The winning CFA candidate's facet->port repartition, if any.

        ``None`` for single-port decisions and for winners whose best
        repartition is burst-granular (``stripe`` / ``burst-lpt`` split below
        the facet, so there is no whole-facet assignment to report).
        """
        try:
            s = self.best_cfa()
        except LookupError:
            return None
        if s.n_ports <= 1 or s.port_assignment is None:
            return None
        from .programs import get_program

        plan = s.candidate.plan(IterSpace(self.space), get_program(self.program),
                                storage=self.storage, codec=self.codec)
        f2p = dict(s.port_assignment)
        loads = [0.0] * s.n_ports
        for length, k in zip(plan.read_runs, plan.read_run_hosts or ()):
            loads[f2p[k]] += length
        for length, k in zip(plan.write_runs, plan.write_run_hosts or ()):
            loads[f2p[k]] += length
        return PortAssignment(
            n_ports=s.n_ports,
            facet_to_port=f2p,
            port_bytes=tuple(loads),
        )

    def best_cfa(self, *, kernel_compatible: bool = False) -> ScoredLayout:
        """Best CFA-family candidate (facet storage is what the pipeline and
        the Pallas kernels consume).

        ``kernel_compatible`` further restricts to layouts the
        ``facet_fetch`` kernel's static BlockSpecs can address: 3-D spaces
        only (the kernel's block maps are 3-D), the paper's default layout,
        facet widths dividing the tile, and at least two tiles per axis (so
        an interior exists).
        """
        d = len(self.space)
        if kernel_compatible and d != 3:
            raise LookupError(
                f"the facet_fetch kernel addresses 3-D layouts only; "
                f"{self.program} @ {self.space} is {d}-D"
            )
        for s in self.ranked:
            c = s.candidate
            if c.scheme != "cfa":
                continue
            if kernel_compatible:
                if not c.is_default_cfa_layout(d):
                    continue
                if any(w and t % w for w, t in zip(self.widths, c.tile)):
                    continue
                if any(n // t < 2 for n, t in zip(self.space, c.tile)):
                    continue
            return s
        raise LookupError(
            f"no {'kernel-compatible ' if kernel_compatible else ''}CFA candidate "
            f"in decision for {self.program} @ {self.space}"
        )

    # -- serialisation ------------------------------------------------------

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d.pop("from_cache")
        d["version"] = _CACHE_VERSION
        return json.dumps(d, indent=1)

    @staticmethod
    def from_json(text: str) -> "LayoutDecision":
        d = json.loads(text)
        version = d.pop("version", None)
        if version != _CACHE_VERSION:
            raise CacheSchemaError(
                f"autotune cache schema v{version}, need v{_CACHE_VERSION} "
                f"(v7 adds the pass-pipeline fingerprint — the ordered "
                f"name/version list of the lowering that ran the search — "
                f"on top of the v6 dataflow overlap axis, the v5 scoring "
                f"basis, the v4 storage discipline and the v3 target + "
                f"backend capability set); delete the stale file "
                f"or clear_cache() to re-search"
            )
        ranked = []
        for s in d.pop("ranked"):
            c = s.pop("candidate")
            cand = LayoutCandidate(
                scheme=c["scheme"],
                tile=tuple(c["tile"]),
                ext_dirs=tuple(map(tuple, c["ext_dirs"])) if c["ext_dirs"] is not None else None,
                contiguity=c["contiguity"],
                block=tuple(c["block"]) if c["block"] is not None else None,
            )
            pa = s.get("port_assignment")
            if pa is not None:
                s["port_assignment"] = tuple((int(k), int(p)) for k, p in pa)
            ranked.append(ScoredLayout(candidate=cand, **s))
        return LayoutDecision(
            program=d["program"],
            space=tuple(d["space"]),
            widths=tuple(d["widths"]),
            model=d["model"],
            seed=d["seed"],
            budget=d["budget"],
            evaluated=d["evaluated"],
            ranked=tuple(ranked),
            n_ports=d.get("n_ports", 1),
            storage=d.get("storage", "redundant"),
            codec=d.get("codec"),
            footprint_weight=d.get("footprint_weight", 0.0),
            score=d.get("score", "modeled"),
            overlap=d.get("overlap", False),
            compute_per_elem_s=d.get("compute_per_elem_s", 0.0),
            pass_pipeline=(tuple((str(n), str(v)) for n, v in d["pass_pipeline"])
                           if d.get("pass_pipeline") is not None else None),
        )

    def summary(self, top: int = 8) -> str:
        """Human-readable ranking table (used by the hillclimb CLI)."""
        lines = [
            f"{self.program} @ space {self.space}  model={self.model}  "
            f"seed={self.seed}  evaluated={self.evaluated} candidates"
            f"{f'  ports={self.n_ports}' if self.n_ports > 1 else ''}"
            f"{f'  storage={self.storage}' if self.storage != 'redundant' else ''}"
            f"{f'  score={self.score}' if self.score != 'modeled' else ''}"
            f"{'  overlap' if self.overlap else ''}"
            f"{'  [cache]' if self.from_cache else ''}",
            f"{'rank':>4} {'eff-bw':>8} {'raw-bw':>8} {'bursts':>6} "
            f"{'redun':>6}  candidate",
        ]
        for i, s in enumerate(self.ranked[:top]):
            peak = s.effective_bw / s.peak_fraction_effective if s.peak_fraction_effective else 0.0
            raw_frac = s.raw_bw / peak if peak else 0.0
            port = f"  [{s.port_strategy} x{s.n_ports}]" if s.n_ports > 1 else ""
            lines.append(
                f"{i:>4} {s.peak_fraction_effective:>7.1%} {raw_frac:>7.1%} "
                f"{s.n_bursts:>6} {s.redundancy:>6.1%}  {s.candidate.key}{port}"
            )
        return "\n".join(lines)


# --------------------------------------------------------------------------
# Candidate enumeration
# --------------------------------------------------------------------------


def candidate_tilings(
    widths: Sequence[int],
    space_sizes: Sequence[int],
    *,
    max_halo_elems: int | None = 64 * 1024,
) -> list[tuple[int, ...]]:
    """Legal rectangular tilings: per axis, divisors of N_a in [w_a, N_a).

    A tile spanning a whole axis degenerates the tiling (no flow across that
    axis), so it is only allowed when no proper divisor fits the facet width.
    ``max_halo_elems`` bounds the on-chip halo buffer prod(t_a + w_a) — the
    paper's BRAM constraint, our VMEM constraint.  Deterministic order:
    descending tile volume (longer bursts first), then lexicographic.

    The enumeration is per-dimension (one divisor list per axis, product
    across axes), so 2-D and 4-D spaces get search spaces of the right
    shape automatically; the seeded sampling in ``autotune`` keeps the
    larger d >= 4 products within budget.
    """
    per_axis: list[list[int]] = []
    for n, w in zip(space_sizes, widths):
        lo = max(1, w)
        divs = [t for t in range(lo, n + 1) if n % t == 0]
        proper = [t for t in divs if t < n]
        per_axis.append(proper or divs)
    out = []
    for t in itertools.product(*per_axis):
        halo = math.prod(ta + wa for ta, wa in zip(t, widths))
        if max_halo_elems is not None and halo > max_halo_elems:
            continue
        out.append(t)
    out.sort(key=lambda t: (-math.prod(t), t))
    return out


def _ext_dir_assignments(widths: Sequence[int]) -> list[tuple[tuple[int, int], ...]]:
    """All per-facet extension-direction assignments (c_k != k, §IV-H)."""
    d = len(widths)
    axes = [k for k in range(d) if widths[k] > 0]
    if d == 1:
        return [tuple((k, k) for k in axes)]
    choices = [[(k, c) for c in range(d) if c != k] for k in axes]
    return [tuple(combo) for combo in itertools.product(*choices)]


def hand_coded_baselines(
    program: StencilProgram,
    space: IterSpace,
    model: BurstModel,
    tile: Sequence[int] | None = None,
    *,
    n_ports: int = 1,
    port_strategies: Sequence[str] = PORT_STRATEGIES,
    storage: str = "redundant",
    codec=None,
    overlap: bool = False,
    compute_per_elem_s: float = 0.0,
) -> dict[str, ScoredLayout]:
    """The paper's hand-coded plans at one tile size, scored under ``model``.

    These are the seeds the autotuner must beat (or match): ``cfa_plan`` with
    the default layout, ``original_layout_plan``, ``bounding_box_plan``, and
    ``data_tiling_plan`` with the block-size sweep of Fig. 15.  With
    ``n_ports > 1`` each baseline is also given its best repartition (the
    single-array baselines can only use burst-granular strategies), keeping
    the comparison against multi-port CFA candidates apples-to-apples.
    """
    t = tuple(tile) if tile is not None else program.default_tile
    cands = {
        "cfa": LayoutCandidate("cfa", t, contiguity="intra-tile"),
        "original": LayoutCandidate("original", t),
        "bbox": LayoutCandidate("bbox", t),
    }
    for div in (1, 2, 4):
        blk = tuple(max(1, x // div) for x in t)
        cands[f"data-tiling/{div}"] = LayoutCandidate("data-tiling", t, block=blk)
    out = {}
    for name, cand in cands.items():
        out[name] = ScoredLayout.from_plan(
            cand, cand.plan(space, program, storage=storage, codec=codec),
            model, n_ports=n_ports, port_strategies=port_strategies,
            overlap=overlap,
            compute_s=compute_per_elem_s * math.prod(cand.tile),
        )
    return out


# --------------------------------------------------------------------------
# Cache
# --------------------------------------------------------------------------


def default_cache_dir() -> Path:
    env = os.environ.get("REPRO_AUTOTUNE_CACHE")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro-torch-cfa" / "autotune"


def clear_cache(cache_dir: Path | str | None = None) -> int:
    """Delete all cached decisions; returns the number removed."""
    root = Path(cache_dir) if cache_dir is not None else default_cache_dir()
    n = 0
    if root.is_dir():
        for f in root.glob("*.json"):
            f.unlink()
            n += 1
    return n


def _device_key(device) -> str:
    """A measurement device as the cache key names it: ``"cuda"`` and
    ``torch.device("cuda")`` name the current card's index, as ``"cuda:0"``
    does on a one-card host."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        index = torch.cuda.current_device() if torch.cuda.is_available() else 0
        dev = torch.device("cuda", index)
    return str(dev)


def _measure_key(measure_kwargs: dict | None) -> list:
    """``measure_kwargs`` as JSON: sorted items, a device by its name."""
    return sorted(
        (k, _device_key(v) if k == "device" else v)
        for k, v in (measure_kwargs or {}).items()
    )


def _cache_key(
    program: StencilProgram,
    space: IterSpace,
    model: BurstModel,
    seed: int,
    budget: int,
    tilings: Sequence[tuple[int, ...]] | None,
    contiguity_levels: Sequence[str],
    max_halo_elems: int | None,
    refine_top: int,
    n_ports: int,
    port_strategies: Sequence[str],
    storage: str,
    codec_id: list | None,
    footprint_weight: float,
    score: str = "modeled",
    measure_top: int | None = None,
    measure_kwargs: dict | None = None,
    overlap: bool = False,
    compute_per_elem_s: float = 0.0,
    pass_fingerprint: tuple[tuple[str, str], ...] | None = None,
) -> str:
    from .executors import capability_fingerprint, host_fingerprint

    blob = json.dumps(
        {
            "version": _CACHE_VERSION,
            "program": program.name,
            "deps": list(map(list, program.deps.vectors)),
            "space": list(space.sizes),
            # the executor capability set (schema v3): a decision is only
            # reusable on the backend envelope it was searched for; the
            # "model" entry below is the target identity (name + parameters)
            "backends": capability_fingerprint(),
            "model": [model.name, model.peak_bytes_per_s, model.setup_s, model.elem_bytes],
            "seed": seed,
            "budget": budget,
            "tilings": list(map(list, tilings)) if tilings is not None else None,
            "contiguity": list(contiguity_levels),
            "max_halo_elems": max_halo_elems,
            "refine_top": refine_top,
            "n_ports": n_ports,
            "port_strategies": list(port_strategies),
            # the storage axis (schema v4)
            "storage": storage,
            "codec": codec_id,
            "footprint_weight": footprint_weight,
            # the score axis (schema v5): a measured decision is only valid
            # on the host (and at the measurement fidelity) it was timed on
            "score": score,
            "host": host_fingerprint() if score == "measured" else None,
            "measure_top": measure_top if score == "measured" else None,
            "measure_kwargs": (_measure_key(measure_kwargs)
                               if score == "measured" else None),
            # the dataflow overlap axis (schema v6)
            "overlap": overlap,
            "compute_per_elem_s": compute_per_elem_s,
            # the pass-pipeline fingerprint (schema v7): a reordered or
            # re-versioned lowering pipeline searches under a fresh key
            "passes": (list(map(list, pass_fingerprint))
                       if pass_fingerprint is not None else None),
        },
        sort_keys=True,
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


def _cache_load(
    path: Path,
    score: str = "modeled",
    pass_fingerprint: tuple[tuple[str, str], ...] | None = None,
) -> LayoutDecision | None:
    try:
        text = path.read_text()
    except OSError:
        return None  # no cache entry for this key
    try:
        decision = LayoutDecision.from_json(text)
        if (pass_fingerprint is not None
                and decision.pass_pipeline != pass_fingerprint):
            # a decision searched under a different lowering pipeline
            # (pass reordered, added, or re-versioned) may rank layouts
            # a current pass would lower differently — reject loudly so
            # the re-search is visible, never silent (schema v7)
            raise CacheSchemaError(
                f"cache entry was searched under pass pipeline "
                f"{decision.pass_pipeline!r} but the current pipeline is "
                f"{pass_fingerprint!r}; an edited lowering invalidates "
                f"cached layout decisions — re-searching"
            )
        if decision.score != score:
            # modeled- and measured-scored decisions rank by different
            # objectives; silently serving one for the other would defeat
            # the whole measured/modeled split — reject loudly instead
            raise CacheSchemaError(
                f"cache entry was written with score={decision.score!r} but "
                f"queried with score={score!r}; measured and modeled "
                f"rankings are never interchangeable — re-searching"
            )
        return decision
    except CacheSchemaError as e:
        # an old-schema decision under this key must not be silently
        # deserialized OR silently dropped: say why a re-search happens
        warnings.warn(f"ignoring {path}: {e}", RuntimeWarning, stacklevel=3)
        return None
    except (ValueError, KeyError, TypeError) as e:
        warnings.warn(
            f"ignoring corrupt autotune cache entry {path}: {e!r}",
            RuntimeWarning, stacklevel=3,
        )
        return None


def _cache_store(path: Path, decision: LayoutDecision) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            fh.write(decision.to_json())
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


# --------------------------------------------------------------------------
# The search
# --------------------------------------------------------------------------


def _plan_verifies(plan) -> bool:
    """Does the candidate's plan pass the static CFA1xx accounting checks?
    ERROR-level candidates are discarded during the search — a layout whose
    plan double-writes or under-covers must never win on modeled time."""
    from .analysis import plan_accounting  # lazy: analysis imports passes

    return not any(d.severity == "ERROR" for d in plan_accounting(plan))


def _sample(items: list, k: int, rng: np.random.Generator) -> list:
    """First half deterministically (best-guess order), rest seeded-random."""
    if len(items) <= k:
        return list(items)
    head = items[: k // 2]
    tail = items[k // 2 :]
    pick = rng.choice(len(tail), size=k - len(head), replace=False)
    return head + [tail[i] for i in sorted(pick)]


def autotune(
    program: StencilProgram | str,
    space: IterSpace | Sequence[int],
    model: BurstModel = AXI_ZC706,
    *,
    seed: int = 0,
    budget: int = 96,
    tilings: Sequence[Sequence[int]] | None = None,
    contiguity_levels: Sequence[str] = CONTIGUITY_LEVELS,
    max_halo_elems: int | None = 64 * 1024,
    refine_top: int = 3,
    n_ports: int = 1,
    port_strategies: Sequence[str] = PORT_STRATEGIES,
    storage: str = "redundant",
    codec=None,
    footprint_weight: float = 0.0,
    score: str = "modeled",
    measure_top: int = 8,
    measure_kwargs: dict | None = None,
    overlap: bool = False,
    compute_per_elem_s: float = 0.0,
    pass_fingerprint: Sequence[Sequence[str]] | None = None,
    cache: bool = True,
    cache_dir: Path | str | None = None,
) -> LayoutDecision:
    """Search the layout space for ``program`` on ``space`` under ``model``.

    Three staged passes, deterministic given ``seed``:

    1. *seeds* — the hand-coded baselines at the program's default tile
       (guaranteeing the decision never scores below them); these ~6 plans
       are always scored, even when ``budget`` is smaller;
    2. *tiling sweep* — the paper-default CFA layout across candidate
       tilings (``candidate_tilings`` unless ``tilings`` overrides);
    3. *layout refinement* — extension-direction assignments x contiguity
       levels on the ``refine_top`` best tilings from stage 2, plus a
       data-tiling block sweep on the best tiling.

    With ``n_ports > 1`` every candidate is additionally co-tuned with its
    best port repartition (``multiport.best_repartition`` over
    ``port_strategies`` x ports-used), and scores/ranking reflect the
    multi-port time — the slowest port, ports running concurrently (§VII).
    The winning facet->port split is carried on each ``ScoredLayout`` and
    surfaced as ``decision.port_assignment``.

    ``storage`` scores every CFA candidate under a facet storage discipline
    (``"redundant"`` — the paper's duplicated layout — or the Ferry-2024
    ``"irredundant"``/``"compressed"`` modes; ``codec`` picks the
    fixed-ratio block codec for the latter), and ``footprint_weight``
    re-weights the ranking by bandwidth per stored element (see
    ``_rank_key``), so footprint-constrained deployments can trade peak
    speed for smaller resident layouts along a reproducible curve.

    ``score="measured"`` re-ranks the top ``measure_top`` modeled
    candidates by *measured wall-clock* of their exact burst schedules on
    this host (``calibrate.measure_plan``; ``measure_kwargs`` forwards
    ``warmup``/``repeats`` and the ``device``, ``"cuda"`` unless named —
    ``compile`` names the stencil's): the measured candidates lead the ranking in
    wall-clock order, each carrying ``measured_time_s`` and the modeled
    time's relative ``model_error``; unmeasured candidates follow in
    modeled order.  Measured decisions cache under a key that folds in the
    host fingerprint and measurement fidelity (schema v5), and the loader
    rejects any modeled/measured score mismatch loudly — the two rankings
    are never interchangeable.

    ``overlap=True`` ranks every candidate by its *overlapped* tile time
    (Fig. 13 DATAFLOW — the ``backend="dataflow"`` schedule), with
    ``compute_per_elem_s`` seconds of tile compute per tile element
    (per-candidate ``compute_s`` = rate x tile volume, so bigger tiles
    carry proportionally more compute to hide transfers behind).  Under
    overlap the search prefers layouts whose transfer fits under the
    compute shadow instead of the absolutely shortest transfer — a
    different optimum whenever compute is non-trivial (schema v6).

    Stages 2 and 3 stay within ``budget`` total evaluations (so
    ``decision.evaluated <= max(budget, number of seeds)``).

    Results are memoised on disk (``cache_dir`` or $REPRO_AUTOTUNE_CACHE or
    ``~/.cache/repro-torch-cfa/autotune``) keyed by every argument above, so a
    repeated call is a single file read (``decision.from_cache`` is True).
    """
    prog = get_program(program) if isinstance(program, str) else program
    sp = space if isinstance(space, IterSpace) else IterSpace(tuple(space))
    if sp.ndim != prog.ndim:
        raise ValueError(
            f"space {sp.sizes} has {sp.ndim} dims but program {prog.name!r} "
            f"is {prog.ndim}-D"
        )
    if n_ports < 1:
        raise ValueError(f"n_ports must be >= 1: {n_ports}")
    if storage not in STORAGE_MODES:
        raise ValueError(f"storage must be one of {STORAGE_MODES}: {storage!r}")
    if codec is not None and storage != "compressed":
        raise ValueError(
            f'a codec only applies to storage="compressed", not {storage!r}'
        )
    if footprint_weight < 0:
        # a negative exponent would silently invert the objective (prefer
        # the LARGEST footprint) — reject like the other search knobs
        raise ValueError(
            f"footprint_weight must be >= 0: {footprint_weight}"
        )
    if score not in SCORE_MODES:
        raise ValueError(f"score must be one of {SCORE_MODES}: {score!r}")
    if measure_top < 1:
        raise ValueError(f"measure_top must be >= 1: {measure_top}")
    if compute_per_elem_s < 0:
        raise ValueError(
            f"compute_per_elem_s must be >= 0: {compute_per_elem_s}"
        )
    cdc = get_codec(codec) if storage == "compressed" else None
    codec_id = [cdc.name, cdc.bits] if cdc is not None else None
    til = tuple(tuple(int(x) for x in t) for t in tilings) if tilings is not None else None
    mkw = dict(measure_kwargs or {})
    if pass_fingerprint is None:
        # a bare autotune() call searches for the default lowering pipeline;
        # compile() threads the fingerprint of whatever pipeline it runs
        from .passes import default_pass_fingerprint
        pass_fingerprint = default_pass_fingerprint()
    fp = tuple((str(n), str(v)) for n, v in pass_fingerprint)

    key = _cache_key(prog, sp, model, seed, budget, til, contiguity_levels,
                     max_halo_elems, refine_top, n_ports, port_strategies,
                     storage, codec_id, footprint_weight,
                     score, measure_top, mkw,
                     overlap, compute_per_elem_s, fp)
    path = (Path(cache_dir) if cache_dir is not None else default_cache_dir()) / f"{key}.json"
    if cache:
        hit = _cache_load(path, score, fp)
        if hit is not None:
            return dataclasses.replace(hit, from_cache=True)

    rng = np.random.default_rng(seed)
    widths = prog.widths

    scored: dict[str, ScoredLayout] = {}

    def score_candidate(cand: LayoutCandidate) -> ScoredLayout | None:
        if cand.key in scored:
            return scored[cand.key]
        try:
            plan = cand.plan(sp, prog, storage=storage, codec=cdc)
        except ValueError:
            return None  # illegal candidate (e.g. w > t); skip
        # (AssertionError deliberately propagates: it flags a layout bug,
        # e.g. a non-contiguous facet write, never an illegal candidate.)
        if not _plan_verifies(plan):
            return None  # statically rejected (ERROR-level diagnostics)
        s = ScoredLayout.from_plan(
            cand, plan, model, n_ports=n_ports,
            port_strategies=port_strategies, overlap=overlap,
            compute_s=compute_per_elem_s * math.prod(cand.tile),
        )
        scored[cand.key] = s
        return s

    # -- stage 1: hand-coded seeds -----------------------------------------
    default_tile_ok = all(
        n % t == 0 and t >= max(1, w)
        for n, t, w in zip(sp.sizes, prog.default_tile, widths)
    )
    if default_tile_ok:
        seeds = hand_coded_baselines(prog, sp, model, n_ports=n_ports,
                                     port_strategies=port_strategies,
                                     storage=storage, codec=cdc,
                                     overlap=overlap,
                                     compute_per_elem_s=compute_per_elem_s)
        for s in seeds.values():
            scored.setdefault(s.candidate.key, s)

    # -- stage 2: default layout across tilings ----------------------------
    all_tilings = list(til) if til is not None else candidate_tilings(
        widths, sp.sizes, max_halo_elems=max_halo_elems
    )
    remaining = max(0, budget - len(scored))
    for t in _sample(all_tilings, remaining * 2 // 3, rng):
        score_candidate(LayoutCandidate("cfa", tuple(t), contiguity="intra-tile"))

    # -- stage 3: layout refinement on the best tilings --------------------
    d = sp.ndim
    cfa_scored = sorted(
        (s for s in scored.values() if s.candidate.scheme == "cfa"),
        key=lambda s: _rank_key(s, footprint_weight),
    )
    top_tiles = []
    for s in cfa_scored:
        if s.candidate.tile not in top_tiles:
            top_tiles.append(s.candidate.tile)
        if len(top_tiles) >= refine_top:
            break
    if top_tiles and len(scored) < budget:
        # data-tiling block sweep at the winning tiling
        t = top_tiles[0]
        for div in (1, 2, 4):
            if len(scored) >= budget:
                break
            blk = tuple(max(1, x // div) for x in t)
            score_candidate(LayoutCandidate("data-tiling", t, block=blk))
    variants = []
    for t in top_tiles:
        for lvl in contiguity_levels:
            for ext in _ext_dir_assignments(widths):
                # the cyclic default is the same layout as ext_dirs=None —
                # canonicalise so it dedupes against the stage-2 candidate
                if all(c == extension_dir(k, d) for k, c in ext):
                    ext = None
                v = LayoutCandidate("cfa", t, ext_dirs=ext, contiguity=lvl)
                if v.key not in scored and all(x.key != v.key for x in variants):
                    variants.append(v)
    remaining = max(0, budget - len(scored))
    for v in _sample(variants, remaining, rng):
        score_candidate(v)

    # -- measured re-ranking (score="measured", schema v5) -----------------
    if score == "measured":
        from .calibrate import measure_plan

        modeled_order = sorted(scored.values(),
                               key=lambda s: _rank_key(s, footprint_weight))
        for s in modeled_order[:measure_top]:
            plan = s.candidate.plan(sp, prog, storage=storage, codec=cdc)
            timed_plan: TransferPlan | PortedPlan = plan
            c_s = compute_per_elem_s * math.prod(s.candidate.tile)
            if n_ports > 1:
                timed_plan = best_repartition(plan, n_ports, model,
                                              port_strategies,
                                              compute_s=c_s, overlap=overlap)
            t_meas = measure_plan(timed_plan, model, compute_s=c_s,
                                  overlap=overlap, **mkw)
            err = (abs(s.time_s - t_meas) / t_meas) if t_meas > 0 else None
            scored[s.candidate.key] = dataclasses.replace(
                s, measured_time_s=t_meas, model_error=err,
            )

    decision = LayoutDecision(
        program=prog.name,
        space=sp.sizes,
        widths=widths,
        model=model.name,
        seed=seed,
        budget=budget,
        evaluated=len(scored),
        ranked=tuple(sorted(scored.values(),
                            key=lambda s: _rank_key(s, footprint_weight))),
        n_ports=n_ports,
        storage=storage,
        codec=cdc.name if cdc is not None else None,
        footprint_weight=footprint_weight,
        score=score,
        overlap=overlap,
        compute_per_elem_s=compute_per_elem_s,
        pass_pipeline=fp,
    )
    if cache:
        _cache_store(path, decision)
    return decision
