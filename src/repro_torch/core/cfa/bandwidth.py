"""Analytic burst/DMA bandwidth model, single- and multi-port.

The paper measures raw and effective bandwidth on a Zynq ZC706 (64-bit AXI HP
port @ 100 MHz -> 800 MB/s peak).  The port runs on a GPU, not an FPGA, so
we model the same first-order mechanics the paper exploits:

    time(plan) = sum over bursts ( T_setup + bytes / BW_peak )

A burst of length L amortises the fixed per-transaction cost T_setup over L
elements; element-wise access pays it per element.  This is exactly the
latency structure described in §II-E, and is the reason CFA's few-long-bursts
plans approach 100 % of the bus bandwidth in Fig. 15.

**Multi-port extension (paper §VII future work).**  A :class:`PortedPlan`
carries the same burst schedule split over ``n_ports`` independent memory
ports (HBM channels / AXI HP ports).  Ports run concurrently, so

    time(ported plan) = max over ports ( time of that port's bursts )

— the balance objective of §VII ("one has to find an adequate repartition of
data over each memory port to balance accesses").  The repartition strategies
that produce a :class:`PortedPlan` from a :class:`TransferPlan` live in
``repro_torch.core.cfa.multiport``.

**Dataflow overlap (Fig. 13 DATAFLOW).**  The paper's accelerator template
runs READ / EXECUTE / WRITE as concurrent dataflow stages, so a tile's
transfer hides behind the previous tile's compute.  ``time`` therefore takes
a per-tile compute term and an ``overlap=`` mode: sequential phases cost
``transfer + compute``; overlapped phases cost the pipeline fill (one burst
setup — the prologue no double-buffer can hide) plus the max of the
remaining transfer and the compute, i.e. ``min(setup, T) + max(T - min(setup,
T), C)``.  The overlapped time is bounded below by ``max(transfer, compute)``
and above by the sequential sum, and equals the plain transfer time when
``compute_s`` is zero.  ``overlap_speedup`` reports the modeled gain; the
``backend="dataflow"`` executor realises the schedule.

One preset:

* ``AXI_ZC706``  — the paper's platform (calibration target for Fig. 15).
  A GPU target comes with the port's calibration.
"""
from __future__ import annotations

import dataclasses

from .compress import stored_bits
from .plans import TransferPlan

__all__ = [
    "BurstModel",
    "PortedPlan",
    "AXI_ZC706",
    "BandwidthReport",
    "overlap_speedup",
]


@dataclasses.dataclass(frozen=True)
class PortedPlan:
    """A tile's burst schedule repartitioned over ``n_ports`` memory ports.

    ``read_runs_by_port[p]`` / ``write_runs_by_port[p]`` are the burst lengths
    (elements) served by port ``p``; a port may be empty (a repartition is
    allowed to leave ports idle — see ``multiport.best_repartition``).
    ``facet_to_port`` records the facet-granular assignment when the strategy
    preserved facet arrays whole (``None`` for burst-granular strategies).
    """

    scheme: str
    n_ports: int
    strategy: str
    read_runs_by_port: tuple[tuple[int, ...], ...]
    write_runs_by_port: tuple[tuple[int, ...], ...]
    read_useful: int
    write_useful: int
    facet_to_port: tuple[tuple[int, int], ...] | None = None
    # storage accounting carried over from the repartitioned TransferPlan
    # (codec_bits drives the per-port burst timing below)
    storage: str = "redundant"
    footprint: int | None = None
    codec_bits: int | None = None

    def __post_init__(self) -> None:
        # Per-port schedules are consumed pairwise (zip with strict=True
        # below); a silent length mismatch would drop ports and under-report
        # the modeled transfer time, so reject it at construction.
        if len(self.read_runs_by_port) != self.n_ports:
            raise ValueError(
                f"read_runs_by_port has {len(self.read_runs_by_port)} "
                f"entries, need n_ports={self.n_ports}"
            )
        if len(self.write_runs_by_port) != self.n_ports:
            raise ValueError(
                f"write_runs_by_port has {len(self.write_runs_by_port)} "
                f"entries, need n_ports={self.n_ports}"
            )

    @property
    def port_elems(self) -> tuple[int, ...]:
        """Elements moved per port (the repartition's load vector)."""
        return tuple(
            int(sum(rr) + sum(wr))
            for rr, wr in zip(self.read_runs_by_port, self.write_runs_by_port,
                              strict=True)
        )

    @property
    def transferred(self) -> int:
        return int(sum(self.port_elems))

    @property
    def useful(self) -> int:
        return self.read_useful + self.write_useful

    @property
    def redundancy(self) -> float:
        return 0.0 if not self.transferred else 1.0 - self.useful / self.transferred

    @property
    def n_bursts(self) -> int:
        return sum(
            len(rr) + len(wr)
            for rr, wr in zip(self.read_runs_by_port, self.write_runs_by_port,
                              strict=True)
        )

    @property
    def balance(self) -> float:
        """max load / mean load over the ports that carry traffic (1.0 =
        perfectly balanced).  Idle ports are a legal repartition choice
        (``best_repartition`` may use fewer ports than available), so they
        do not count against the balance of the ports actually used."""
        loads = [l for l in self.port_elems if l > 0]
        mean = sum(loads) / len(loads) if loads else 0.0
        return float(max(loads) / mean) if mean > 0 else 1.0


@dataclasses.dataclass(frozen=True)
class BurstModel:
    name: str
    peak_bytes_per_s: float
    setup_s: float  # fixed cost per burst/DMA descriptor
    elem_bytes: int

    def burst_bytes(self, length: int, codec_bits: int | None = None) -> float:
        """Wire bytes of one burst of ``length`` elements.

        With ``codec_bits`` (fixed-ratio block compression, Ferry 2024) the
        burst carries one raw header word plus ``codec_bits``-wide residuals
        — same descriptor, fewer bytes; structure (and setup cost) unchanged.
        The size formula is ``compress.stored_bits``, shared with the
        codec's footprint accounting.
        """
        if not codec_bits:
            return length * self.elem_bytes
        return stored_bits(length, 8 * self.elem_bytes, codec_bits) / 8

    def time_s(self, runs: tuple[int, ...], codec_bits: int | None = None) -> float:
        return sum(
            self.setup_s + self.burst_bytes(r, codec_bits) / self.peak_bytes_per_s
            for r in runs
        )

    def transfer_time_s(self, plan: "TransferPlan | PortedPlan") -> float:
        """Modeled transfer time of a whole plan (no compute term).

        Single-port :class:`TransferPlan`: sum over all bursts.  Multi-port
        :class:`PortedPlan`: ports transfer concurrently, so the tile waits
        for the slowest port — the max over per-port burst schedules (§VII).
        A plan carrying ``codec_bits`` is timed at its compressed
        bytes-per-burst.
        """
        cb = getattr(plan, "codec_bits", None)
        if isinstance(plan, PortedPlan):
            # strict: a ragged ported plan must fail loudly, not drop the
            # trailing ports from the max (under-reporting the time)
            return max(
                self.time_s(rr, cb) + self.time_s(wr, cb)
                for rr, wr in zip(plan.read_runs_by_port,
                                  plan.write_runs_by_port, strict=True)
            )
        return self.time_s(plan.read_runs, cb) + self.time_s(plan.write_runs, cb)

    def time(
        self, plan: "TransferPlan | PortedPlan", *,
        compute_s: float = 0.0, overlap: bool = False,
    ) -> float:
        """Modeled tile time: transfers plus ``compute_s`` of tile compute.

        Sequential phases (every executor except ``dataflow``) pay the sum
        ``transfer + compute``.  With ``overlap=True`` (Fig. 13 DATAFLOW:
        fetch/compute/commit run as pipelined stages) the transfer streams
        behind the compute and only the pipeline fill — one burst's setup,
        ``min(setup_s, transfer)`` — stays exposed:

            time = fill + max(transfer - fill, compute_s)

        which is ``<= transfer + compute_s`` (the sequential schedule),
        ``>= max(transfer, compute_s)`` (neither engine can be beaten), and
        exactly the transfer time when ``compute_s == 0``.
        """
        if compute_s < 0.0:
            raise ValueError(f"compute_s must be >= 0, got {compute_s}")
        t = self.transfer_time_s(plan)
        if not overlap:
            return t + compute_s
        fill = min(self.setup_s, t)
        return fill + max(t - fill, compute_s)

    def plan_bytes(self, plan: "TransferPlan | PortedPlan") -> float:
        """Wire bytes the whole plan moves (compression applied per burst)."""
        cb = getattr(plan, "codec_bits", None)
        if isinstance(plan, PortedPlan):
            runs = [r for rr in plan.read_runs_by_port for r in rr]
            runs += [w for wr in plan.write_runs_by_port for w in wr]
        else:
            runs = list(plan.read_runs) + list(plan.write_runs)
        return sum(self.burst_bytes(r, cb) for r in runs)

    @property
    def setup_elems(self) -> float:
        """T_setup expressed in element-transfer time units (the burst-length
        "knee": runs much longer than this amortise the setup away)."""
        return self.setup_s * self.peak_bytes_per_s / self.elem_bytes


# The paper's AXI HP port: 64-bit @ 100 MHz = 800 MB/s; a non-burst access
# costs tens of cycles of addressing/DRAM latency.  25 cycles @ 100 MHz.
AXI_ZC706 = BurstModel(
    name="axi-zc706", peak_bytes_per_s=800e6, setup_s=250e-9, elem_bytes=8
)


@dataclasses.dataclass(frozen=True)
class BandwidthReport:
    scheme: str
    model: str
    raw_bw: float  # transferred (wire) bytes / time
    effective_bw: float  # useful (logical) bytes / time
    peak_fraction_raw: float
    peak_fraction_effective: float
    n_bursts: int
    redundancy: float
    n_ports: int = 1
    storage: str = "redundant"
    footprint: int | None = None  # whole-layout stored elements
    # measured-vs-modeled verification (``repro_torch.core.cfa.calibrate``):
    # wall-clock seconds of the same schedule on this host, and the
    # modeled time's relative error against it; None when not measured
    measured_time_s: float | None = None
    model_error: float | None = None
    # dataflow accounting: the compute term folded into the time and
    # whether transfers were overlapped with it (Fig. 13 DATAFLOW)
    compute_s: float = 0.0
    overlap: bool = False

    @staticmethod
    def evaluate(
        plan: "TransferPlan | PortedPlan", model: BurstModel,
        measured_s: float | None = None,
        *, compute_s: float = 0.0, overlap: bool = False,
    ) -> "BandwidthReport":
        """Bandwidth of a plan under ``model``.

        For a :class:`PortedPlan` the time is the slowest port's (ports run
        concurrently), so raw/effective bandwidth are *aggregate* across
        ports and ``peak_fraction_*`` is relative to a single port's peak —
        an n-port plan can exceed 1.0, which is the point of §VII.  For a
        compressed plan ``raw_bw`` counts wire bytes (never above peak per
        port) while ``effective_bw`` counts the logical bytes delivered —
        compression can push it past the wire peak, which is the point of
        the Ferry-2024 layout.

        ``measured_s`` (a wall-clock measurement of the same schedule, see
        ``calibrate.measure_plan``) fills ``measured_time_s`` and the
        modeled time's relative error ``model_error``.  ``compute_s`` /
        ``overlap`` fold a per-tile compute term into the time the
        bandwidths divide by (``overlap=True`` hides the transfer behind it
        — the dataflow executor's schedule).
        """
        t = model.time(plan, compute_s=compute_s, overlap=overlap)
        raw = model.plan_bytes(plan) / t if t else 0.0
        eff = plan.useful * model.elem_bytes / t if t else 0.0
        err = None
        if measured_s is not None and measured_s > 0.0:
            err = abs(t - measured_s) / measured_s
        return BandwidthReport(
            scheme=plan.scheme,
            model=model.name,
            raw_bw=raw,
            effective_bw=eff,
            peak_fraction_raw=raw / model.peak_bytes_per_s,
            peak_fraction_effective=eff / model.peak_bytes_per_s,
            n_bursts=plan.n_bursts,
            redundancy=plan.redundancy,
            n_ports=getattr(plan, "n_ports", 1),
            storage=getattr(plan, "storage", "redundant"),
            footprint=getattr(plan, "footprint", None),
            measured_time_s=measured_s,
            model_error=err,
            compute_s=compute_s,
            overlap=overlap,
        )


def overlap_speedup(
    plan: "TransferPlan | PortedPlan", model: BurstModel, compute_s: float,
) -> dict:
    """Modeled gain of the dataflow schedule over sequential phases.

    Returns ``t_sequential_s`` (``transfer + compute``), ``t_overlapped_s``
    (Fig. 13 DATAFLOW pipelining, see :meth:`BurstModel.time`), their ratio
    ``speedup``, and the ``bound`` — the best speedup any overlap could give
    this plan, ``(T + C) / max(T, C)`` (2.0 at the balanced point).
    """
    t_seq = model.time(plan, compute_s=compute_s, overlap=False)
    t_ovl = model.time(plan, compute_s=compute_s, overlap=True)
    transfer = model.transfer_time_s(plan)
    best = max(transfer, compute_s)
    return {
        "transfer_s": transfer,
        "compute_s": compute_s,
        "t_sequential_s": t_seq,
        "t_overlapped_s": t_ovl,
        "speedup": t_seq / t_ovl if t_ovl > 0.0 else 1.0,
        "bound": t_seq / best if best > 0.0 else 1.0,
    }
