"""Static CFA checks — the slice the layout search needs.

The reference package's analysis layer is a suite of read-only compiler
passes (single-assignment and coverage proofs, overlap race checks, the
burst lint, contract checks) behind ``compile(..., verify=True)``.  The
port carries its :class:`Diagnostic` record and :func:`plan_accounting`,
the O(#runs) CFA1xx accounting check ``autotune`` runs on every candidate
plan, so the port's layout search discards the same candidates the
reference's does.  The rest of the suite (``verify``, ``lint_plan``,
``AnalysisReport``) arrives with the port's analysis slice.
"""
from __future__ import annotations

import dataclasses

from .plans import TransferPlan

__all__ = [
    "SEVERITIES",
    "FIXIT_KNOBS",
    "Diagnostic",
    "plan_accounting",
]

#: Diagnostic severities, weakest first (``max_severity`` compares by index).
SEVERITIES = ("INFO", "WARN", "ERROR")

#: The layout knobs a ``fixit`` may name — each is a ``cfa.compile`` /
#: ``LayoutCandidate`` parameter the user can actually turn.
FIXIT_KNOBS = ("ext_dirs", "contiguity", "storage", "n_ports")


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
