"""Multi-port facet repartition — the paper's stated future work (§VII):

    "the machine model we have considered may be extended to multi-port
     memory accesses, such as high-bandwidth memory ... one has to find an
     adequate repartition of data over each memory port to balance accesses."

On TPU-class HBM the analogue is distributing the facet arrays across HBM
channels (or, across chips, the sharding of facet arrays over a mesh axis).
Because CFA gives every facet a *static, per-tile-uniform* transfer size,
the balance problem is a deterministic multiprocessor-scheduling instance:
assign work units to ports so the heaviest port carries the least possible
time per tile (``BurstModel.time`` of a ``PortedPlan`` = max over ports).

Two granularities of "work unit" are searched:

* **facet-granular** — whole facet arrays go to ports, preserving each
  facet's contiguity untouched.  ``facet-lpt`` is LPT (longest-processing-
  time greedy, 4/3-optimal) over per-facet burst time; ``facet-rr`` is the
  round-robin baseline.  Requires the plan's run->facet attribution
  (``TransferPlan.read_run_hosts``), i.e. a CFA plan.
* **burst-granular** — individual bursts are schedulable: ``burst-lpt``
  LPT-schedules whole bursts across ports; ``stripe`` splits every burst
  into near-equal contiguous chunks, one per port (address interleaving
  across channels, each chunk paying its own descriptor setup).  These work
  for any layout scheme, including the paper's baselines.

``best_repartition`` searches strategies x ports-used (a repartition may
leave ports idle, so more available ports never models slower) and returns
the fastest :class:`PortedPlan` under the burst model.  ``assign_ports`` /
``port_speedup`` are the facet-level entry points used by the autotuner,
the sharded wavefront executor and the multiport benchmark.

Everything here is dimension-generic: facets are keyed by canonical axis,
so a 2-D program's 2 facets or a 4-D program's 4 facets repartition through
the same code as the 3-D Table I suite.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .bandwidth import BurstModel, PortedPlan
from .facets import build_facet_specs
from .plans import TransferPlan, cfa_plan, interior_tile
from .spaces import Deps, IterSpace, Tiling

__all__ = [
    "PortAssignment",
    "PORT_STRATEGIES",
    "assign_ports",
    "repartition",
    "best_repartition",
    "port_speedup",
]

PORT_STRATEGIES = ("facet-lpt", "facet-rr", "burst-lpt", "stripe")


@dataclasses.dataclass(frozen=True)
class PortAssignment:
    n_ports: int
    facet_to_port: dict[int, int]  # facet axis -> port id
    port_bytes: tuple[float, ...]  # per-tile traffic per port (elements)

    @property
    def balance(self) -> float:
        """max port load / mean port load (1.0 = perfect)."""
        loads = np.asarray(self.port_bytes)
        mean = loads.mean() if loads.size else 0.0
        return float(loads.max() / mean) if mean > 0 else 1.0


def _facet_traffic(space: IterSpace, deps: Deps, tiling: Tiling) -> dict[int, float]:
    """Per-tile elements moved per facet array (write block + its share of
    the read plan, which CFA's host assignment makes per-facet exact)."""
    specs = build_facet_specs(space, deps, tiling)
    tile = interior_tile(space, tiling)
    from .plans import _assign_hosts, flow_in_points
    from .spaces import facet_widths

    widths = facet_widths(deps)
    fin = flow_in_points(space, deps, tiling, tile)
    hosts = _assign_hosts(fin, tile, tiling, widths, specs)
    traffic = {}
    for k, spec in specs.items():
        traffic[k] = float(spec.block_elems)  # flow-out write
        traffic[k] += float(hosts[k].size)  # flow-in reads served by facet k
    return traffic


def assign_ports(space: IterSpace, deps: Deps, tiling: Tiling,
                 n_ports: int) -> PortAssignment:
    """LPT assignment of whole facet arrays to ``n_ports`` ports."""
    traffic = _facet_traffic(space, deps, tiling)
    loads = [0.0] * n_ports
    assign = {}
    for k in sorted(traffic, key=lambda k: -traffic[k]):  # LPT greedy
        p = int(np.argmin(loads))
        assign[k] = p
        loads[p] += traffic[k]
    return PortAssignment(n_ports, assign, tuple(loads))


# --------------------------------------------------------------------------
# Repartition strategies: TransferPlan -> PortedPlan
# --------------------------------------------------------------------------


def _run_weight(length: int, model: BurstModel | None) -> float:
    """Scheduling weight of one burst: its modeled time (or elements)."""
    if model is None:
        return float(length)
    return model.setup_s + length * model.elem_bytes / model.peak_bytes_per_s


def _facet_partition(plan: TransferPlan, n_ports: int, *, lpt: bool,
                     model: BurstModel | None):
    """Group runs by host facet, place whole facets on ports (LPT or RR)."""
    if plan.read_run_hosts is None or plan.write_run_hosts is None:
        raise ValueError(
            f"facet-granular repartition needs run->facet attribution, which "
            f"{plan.scheme!r} plans do not carry (use a burst-granular strategy)"
        )
    groups: dict[int, tuple[list[int], list[int]]] = {}
    for length, k in zip(plan.read_runs, plan.read_run_hosts):
        groups.setdefault(k, ([], []))[0].append(length)
    for length, k in zip(plan.write_runs, plan.write_run_hosts):
        groups.setdefault(k, ([], []))[1].append(length)
    weight = {
        k: sum(_run_weight(r, model) for r in rr + wr)
        for k, (rr, wr) in groups.items()
    }
    reads = [[] for _ in range(n_ports)]
    writes = [[] for _ in range(n_ports)]
    loads = [0.0] * n_ports
    assign: dict[int, int] = {}
    if lpt:
        order = sorted(groups, key=lambda k: (-weight[k], k))
    else:  # round-robin in canonical facet-axis order
        order = sorted(groups)
    for i, k in enumerate(order):
        p = int(np.argmin(loads)) if lpt else i % n_ports
        assign[k] = p
        loads[p] += weight[k]
        reads[p].extend(groups[k][0])
        writes[p].extend(groups[k][1])
    return reads, writes, assign


def _burst_lpt_partition(plan: TransferPlan, n_ports: int,
                         model: BurstModel | None):
    """LPT over individual bursts (reads and writes jointly scheduled)."""
    runs = [(length, True) for length in plan.read_runs]
    runs += [(length, False) for length in plan.write_runs]
    runs.sort(key=lambda x: -x[0])
    reads = [[] for _ in range(n_ports)]
    writes = [[] for _ in range(n_ports)]
    loads = [0.0] * n_ports
    for length, is_read in runs:
        p = int(np.argmin(loads))
        loads[p] += _run_weight(length, model)
        (reads if is_read else writes)[p].append(length)
    return reads, writes


def _stripe_partition(plan: TransferPlan, n_ports: int):
    """Split every burst into ``n_ports`` near-equal contiguous chunks.

    Models address-interleaving each extent across channels: chunk ``p`` of
    a burst goes to port ``p`` and pays its own descriptor setup, so striping
    wins exactly when bursts are long relative to the model's setup knee."""
    reads = [[] for _ in range(n_ports)]
    writes = [[] for _ in range(n_ports)]
    for length in plan.read_runs:
        base, rem = divmod(length, n_ports)
        for p in range(n_ports):
            chunk = base + (1 if p < rem else 0)
            if chunk:
                reads[p].append(chunk)
    for length in plan.write_runs:
        base, rem = divmod(length, n_ports)
        for p in range(n_ports):
            chunk = base + (1 if p < rem else 0)
            if chunk:
                writes[p].append(chunk)
    return reads, writes


def repartition(
    plan: TransferPlan,
    n_ports: int,
    strategy: str = "facet-lpt",
    *,
    model: BurstModel | None = None,
) -> PortedPlan:
    """Split ``plan``'s bursts over ``n_ports`` ports with one strategy.

    ``model`` weights LPT bin-packing by modeled burst time (setup included);
    without it, weights are element counts.  Raises ``ValueError`` for a
    facet-granular strategy on a plan without facet attribution.
    """
    if n_ports <= 0:
        raise ValueError(f"n_ports must be positive: {n_ports}")
    if strategy not in PORT_STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; have {PORT_STRATEGIES}")
    assign = None
    if strategy in ("facet-lpt", "facet-rr"):
        reads, writes, facet_assign = _facet_partition(
            plan, n_ports, lpt=(strategy == "facet-lpt"), model=model
        )
        assign = tuple(sorted(facet_assign.items()))
    elif strategy == "burst-lpt":
        reads, writes = _burst_lpt_partition(plan, n_ports, model)
    else:  # stripe
        reads, writes = _stripe_partition(plan, n_ports)
    return PortedPlan(
        scheme=plan.scheme,
        n_ports=n_ports,
        strategy=strategy,
        read_runs_by_port=tuple(tuple(r) for r in reads),
        write_runs_by_port=tuple(tuple(w) for w in writes),
        read_useful=plan.read_useful,
        write_useful=plan.write_useful,
        facet_to_port=assign,
        storage=plan.storage,
        footprint=plan.footprint,
        codec_bits=plan.codec_bits,
    )


def _pad_ports(pp: PortedPlan, n_ports: int) -> PortedPlan:
    """Re-express a p-port plan as an n-port plan with idle trailing ports."""
    if pp.n_ports == n_ports:
        return pp
    pad = n_ports - pp.n_ports
    return dataclasses.replace(
        pp,
        n_ports=n_ports,
        read_runs_by_port=pp.read_runs_by_port + ((),) * pad,
        write_runs_by_port=pp.write_runs_by_port + ((),) * pad,
    )


def best_repartition(
    plan: TransferPlan,
    n_ports: int,
    model: BurstModel,
    strategies: Sequence[str] = PORT_STRATEGIES,
    *,
    time_fn=None,
    compute_s: float = 0.0,
    overlap: bool = False,
) -> PortedPlan:
    """The fastest repartition of ``plan`` over up to ``n_ports`` ports.

    Searches every strategy at every port count ``p <= n_ports`` (using fewer
    ports than available is always legal — idle ports cost nothing — which
    also makes the returned time monotonically non-increasing in ``n_ports``).
    Deterministic tiebreak: earliest strategy in ``strategies``, then fewest
    ports used.  Facet-granular strategies are skipped silently for plans
    without facet attribution; when *no* requested strategy applies (e.g.
    facet-only strategies on a baseline plan) the trivial single-port
    schedule — always legal — is returned with strategy ``"single-port"``.

    ``time_fn`` overrides how candidate :class:`PortedPlan`\\ s are scored
    (default ``model.time``) — e.g. ``calibrate.measure_plan`` to pick the
    repartition by measured wall-clock instead of the analytic model.  The
    ``model`` still weights the LPT bin-packing inside each strategy.
    ``compute_s`` / ``overlap`` are folded into the default score
    (``model.time(pp, compute_s=..., overlap=...)``) so a dataflow
    repartition is picked by its *overlapped* tile time; they are ignored
    when ``time_fn`` is given.
    """
    if time_fn is not None:
        score = time_fn
    else:
        def score(pp):
            return model.time(pp, compute_s=compute_s, overlap=overlap)
    best: PortedPlan | None = None
    best_key: tuple | None = None
    for p in range(1, n_ports + 1):
        for si, strat in enumerate(strategies):
            try:
                pp = repartition(plan, p, strat, model=model)
            except ValueError:
                continue
            key = (score(pp), si, p)
            if best_key is None or key < best_key:
                best, best_key = pp, key
    if best is None:
        best = PortedPlan(
            scheme=plan.scheme,
            n_ports=1,
            strategy="single-port",
            read_runs_by_port=(plan.read_runs,),
            write_runs_by_port=(plan.write_runs,),
            read_useful=plan.read_useful,
            write_useful=plan.write_useful,
            storage=plan.storage,
            footprint=plan.footprint,
            codec_bits=plan.codec_bits,
        )
    return _pad_ports(best, n_ports)


def port_speedup(
    space: IterSpace,
    deps: Deps,
    tiling: Tiling,
    n_ports: int,
    model: BurstModel,
    *,
    strategies: Sequence[str] = PORT_STRATEGIES,
) -> dict:
    """Aggregate-bandwidth gain of an n-port repartition vs a single port.

    Evaluates the interior-tile CFA plan, repartitions it with
    ``best_repartition`` and compares modeled times: each port serves its
    bursts independently; tile time = the slowest port (ports run
    concurrently, the paper's §VII balance objective)."""
    plan = cfa_plan(space, deps, tiling)
    t_single = model.time(plan)
    pp = best_repartition(plan, n_ports, model, strategies)
    t_ports = model.time(pp)
    return {
        "n_ports": n_ports,
        "strategy": pp.strategy,
        "balance": pp.balance,
        "t_single_us": 1e6 * t_single,
        "t_multi_us": 1e6 * t_ports,
        "speedup": t_single / t_ports if t_ports else 1.0,
        "assignment": dict(pp.facet_to_port) if pp.facet_to_port is not None else None,
    }
