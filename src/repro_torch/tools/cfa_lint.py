"""Lint the program x storage x backend matrix with the static verifier.

A CLI over ``cfa.compile(..., verify=True)``'s analysis suite
(``repro_torch.core.cfa.analysis``): compile every requested combination on
``--device``, collect each :class:`AnalysisReport`, and render the findings
as text or JSON.  The exit code is the matrix's max severity — ``0`` clean
(or INFO only), ``1`` WARN, ``2`` ERROR — so CI can gate on it;
``--strict`` promotes WARN to the failing exit code.

    python -m repro_torch.tools.cfa_lint
    python -m repro_torch.tools.cfa_lint jacobi2d5p heat3d --json
    python -m repro_torch.tools.cfa_lint --storages irredundant \\
        --backends wavefront --strict
    python -m repro_torch.tools.cfa_lint jacobi2d5p --include-baselines --device cpu

JSON schema (``--json``; the reference's, documented in docs/analysis.md):

    {
      "target": "axi-zc706",
      "max_severity": "WARN" | "ERROR" | "INFO" | null,
      "exit_code": 0 | 1 | 2,
      "entries": [
        {
          "program": "jacobi2d5p",
          "space": [8, 8, 8],
          "storage": "redundant",
          "backend": "wavefront",          # or "plan:original" for baselines
          "layout": "cfa[t=4x4x4,intra-tile]",
          "max_severity": ...,             # null when clean
          "diagnostics": [Diagnostic.to_dict(), ...]
        }, ...
      ]
    }
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch import cfa
from repro_torch.core.cfa import (
    STORAGE_MODES,
    IterSpace,
    available_backends,
    get_program,
    get_target,
)
from repro_torch.core.cfa.analysis import SEVERITIES, lint_plan
from repro_torch.core.cfa.plans import (
    bounding_box_plan,
    data_tiling_plan,
    original_layout_plan,
)
from repro_torch.core.cfa.spaces import Tiling

#: every Table I program plus the 2-D/4-D extension cases — the green matrix
DEFAULT_PROGRAMS = (
    "jacobi2d5p", "jacobi2d9p", "jacobi2d9p-gol", "gaussian",
    "smith-waterman-3seq", "heat1d", "heat3d",
)

#: the Fig. 15 baseline layouts ``--include-baselines`` lints (plan-only:
#: baselines are not executable, so only the CFA3xx lint applies)
BASELINE_PLANS = {
    "original": original_layout_plan,
    "bbox": bounding_box_plan,
    "data-tiling": data_tiling_plan,
}


def _exit_code(max_severity: str | None, *, strict: bool) -> int:
    if max_severity == "ERROR":
        return 2
    if max_severity == "WARN":
        return 2 if strict else 1
    return 0


def _worst(severities) -> str | None:
    sevs = [s for s in severities if s is not None]
    return max(sevs, key=SEVERITIES.index) if sevs else None


def lint_matrix(
    programs=DEFAULT_PROGRAMS,
    *,
    target="axi-zc706",
    storages=STORAGE_MODES,
    backends=None,
    include_baselines=False,
    device="cuda",
) -> list[dict]:
    """Compile + verify every combination on ``device``; one JSON-ready
    entry each."""
    tgt = get_target(target)
    entries: list[dict] = []
    for name in programs:
        prog = get_program(name)
        space = tuple(2 * t for t in prog.default_tile)
        for storage in storages:
            capable = available_backends(prog, IterSpace(space), 1, storage)
            if backends is not None:
                capable = [b for b in capable if b in backends]
            for be in capable:
                compiled = cfa.compile(name, space, target=tgt, layout="default",
                                       backend=be, storage=storage, device=device)
                report = cfa.verify(compiled, raise_on_error=False)
                entries.append({
                    "program": name,
                    "space": list(space),
                    "storage": storage,
                    "backend": be,
                    "layout": compiled.layout.key,
                    "max_severity": report.max_severity,
                    "diagnostics": [d.to_dict() for d in report.diagnostics],
                })
        if include_baselines:
            for bname, make_plan in BASELINE_PLANS.items():
                plan = make_plan(IterSpace(space), prog.deps,
                               Tiling(prog.default_tile))
                diags = lint_plan(plan, tgt.model)
                entries.append({
                    "program": name,
                    "space": list(space),
                    "storage": "redundant",
                    "backend": f"plan:{bname}",
                    "layout": plan.scheme,
                    "max_severity": _worst(d.severity for d in diags),
                    "diagnostics": [d.to_dict() for d in diags],
                })
    return entries


def render_text(entries: list[dict], out) -> None:
    clean = 0
    for e in entries:
        where = (f"{e['program']} @ {tuple(e['space'])} "
                 f"[{e['storage']}, {e['backend']}]")
        if not e["diagnostics"]:
            clean += 1
            continue
        print(f"{where}: {e['layout']}", file=out)
        for d in e["diagnostics"]:
            loc = f" [facet {d['facet']}]" if "facet" in d else ""
            fix = f" (fixit: {d['fixit']})" if "fixit" in d else ""
            print(f"  {d['severity']} {d['code']}{loc}: {d['message']}{fix}",
                  file=out)
    flagged = len(entries) - clean
    print(f"{len(entries)} combination(s) linted: {clean} clean, "
          f"{flagged} with findings", file=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("programs", nargs="*", default=None,
                    help=f"programs to lint (default: all of "
                         f"{', '.join(DEFAULT_PROGRAMS)})")
    ap.add_argument("--target", default="axi-zc706",
                    help="registered target name (default: axi-zc706)")
    ap.add_argument("--storages", nargs="+", default=list(STORAGE_MODES),
                    choices=STORAGE_MODES, metavar="STORAGE",
                    help="storage disciplines to cover (default: all)")
    ap.add_argument("--backends", nargs="+", default=None, metavar="BACKEND",
                    help="restrict to these backends (default: every "
                         "capable one)")
    ap.add_argument("--include-baselines", action="store_true",
                    help="also lint the Fig. 15 baseline layouts "
                         "(original/bbox/data-tiling; plan-level CFA3xx only)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output (schema in docs/analysis.md)")
    ap.add_argument("--strict", action="store_true",
                    help="WARN exits 2 like ERROR (warnings-as-errors)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the stencils compile for (default: cuda)")
    args = ap.parse_args(argv)

    entries = lint_matrix(
        tuple(args.programs) if args.programs else DEFAULT_PROGRAMS,
        target=args.target, storages=tuple(args.storages),
        backends=tuple(args.backends) if args.backends else None,
        include_baselines=args.include_baselines, device=args.device,
    )
    worst = _worst(e["max_severity"] for e in entries)
    code = _exit_code(worst, strict=args.strict)
    if args.as_json:
        json.dump({"target": args.target, "max_severity": worst,
                   "exit_code": code, "entries": entries},
                  sys.stdout, indent=1)
        print()
    else:
        render_text(entries, sys.stdout)
    return code


if __name__ == "__main__":
    raise SystemExit(main())
