"""Dump a compile's pass trace as JSON — the lowering, stage by stage.

A thin CLI over ``cfa.compile``: lower one (program, space) request on
``--device`` through the default ``PassPipeline`` and print every
``PassTrace`` entry (pass name, version, wall seconds, artifact diff) plus a
summary of the resulting ``CompiledStencil``.  What a human reaches for when
a compile picks a surprising backend or layout.

    python -m repro_torch.tools.dump_pipeline jacobi2d5p 16 32 32
    python -m repro_torch.tools.dump_pipeline heat3d 4 8 8 8 \\
        --layout default --backend sweep
    python -m repro_torch.tools.dump_pipeline jacobi2d5p 8 8 8 \\
        --target axi-zc706 --storage irredundant --layout 4,4,4
    python -m repro_torch.tools.dump_pipeline jacobi2d5p 8 8 8 \\
        --host-budget 2000      # watch the distribute pass raise n_ports
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch import cfa


def parse_layout(text: str):
    """``autotune`` / ``default`` verbatim, else a comma-separated tile."""
    if text in ("autotune", "default"):
        return text
    return tuple(int(x) for x in text.replace(",", " ").split())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("program", help="Table I program name, e.g. jacobi2d5p")
    ap.add_argument("space", type=int, nargs="+", help="iteration-space sizes")
    ap.add_argument("--target", default="axi-zc706",
                    help="registered target name (default: axi-zc706)")
    ap.add_argument("--layout", default="default", type=parse_layout,
                    help='"autotune", "default", or a tile like 4,4,4 '
                         '(default: default — no search)')
    ap.add_argument("--backend", default="auto",
                    help="backend name or auto (default: auto)")
    ap.add_argument("--storage", default="redundant",
                    choices=("redundant", "irredundant", "compressed"))
    ap.add_argument("--n-ports", type=int, default=1)
    ap.add_argument("--overlap", action="store_true",
                    help="rank/lower for overlapped fetch/compute/commit")
    ap.add_argument("--host-budget", type=int, default=None,
                    help="per-host facet-memory budget in bytes (the "
                         "distribute pass shards spaces that exceed it)")
    ap.add_argument("--budget", type=int, default=32,
                    help="autotune evaluation budget (only with "
                         "--layout autotune)")
    ap.add_argument("--verify", action="store_true",
                    help="run the static analysis suite and append its "
                         "AnalysisReport to the JSON trace")
    ap.add_argument("--device", default="cuda",
                    help="torch device the stencil compiles for (default: cuda)")
    args = ap.parse_args(argv)

    compiled = cfa.compile(
        args.program, tuple(args.space), target=args.target,
        layout=args.layout, backend=args.backend, storage=args.storage,
        n_ports=args.n_ports, overlap=args.overlap,
        host_budget=args.host_budget,
        autotune_kwargs=(dict(budget=args.budget)
                         if args.layout == "autotune" else None),
        device=args.device,
    )
    out = {
        "program": args.program,
        "space": list(args.space),
        "target": args.target,
        "passes": [t.to_dict() for t in compiled.trace()],
        "compiled": {
            "backend": compiled.backend,
            "layout": compiled.layout.key,
            "storage": compiled.storage,
            "n_ports": compiled.n_ports,
            "distributed": compiled.distributed,
        },
    }
    if args.verify:
        report = cfa.verify(compiled, raise_on_error=False)
        out["analysis"] = report.to_dict()
    json.dump(out, sys.stdout, indent=1)
    print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
