"""Run one stencil under the trace recorder and export a Chrome trace.

A thin CLI over ``cfa.compile(..., trace=True)``: compile one (program,
space) request on ``--device``, run it on seeded random inputs, and write
the recorded timeline as Chrome trace-event JSON (load the file in Perfetto
or ``chrome://tracing``).  ``--validate`` additionally checks the emitted
JSON against the schema in ``docs/tracing.md`` and asserts the runtime
counters reconcile exactly against the per-tile ``TransferPlan``
accounting.  The spans are host-clock spans: on the card they time the
enqueue, not the device work.

    python -m repro_torch.tools.cfa_trace jacobi2d5p 8 8 8 \\
        --layout 4,4,4 --backend dataflow -o trace.json --validate
    python -m repro_torch.tools.cfa_trace heat3d 4 8 8 8 \\
        --backend sweep --summary --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from repro_torch import cfa
from repro_torch.core.cfa.obs import validate_chrome_trace
from repro_torch.core.cfa.programs import get_program


def parse_layout(text: str):
    """``autotune`` / ``default`` verbatim, else a comma-separated tile."""
    if text in ("autotune", "default"):
        return text
    return tuple(int(x) for x in text.replace(",", " ").split())


def seeded_inputs(name: str, space: tuple[int, ...], seed: int):
    """Random flow-in block shaped (w_0, *space[1:]) — what every executor
    consumes as the time-axis boundary."""
    w0 = get_program(name).widths[0]
    rng = np.random.default_rng(seed)
    return rng.normal(size=(w0, *space[1:]))


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
    ap.add_argument("--seed", type=int, default=0,
                    help="input RNG seed (default: 0)")
    ap.add_argument("-o", "--out", type=Path, default=None,
                    help="write the Chrome trace JSON here "
                         "(default: stdout)")
    ap.add_argument("--validate", action="store_true",
                    help="check the JSON against the docs/tracing.md "
                         "schema and assert counters reconcile against "
                         "the plan accounting; non-zero exit on failure")
    ap.add_argument("--summary", action="store_true",
                    help="print span/counter totals to stderr")
    ap.add_argument("--device", default="cuda",
                    help="torch device the stencil compiles for and runs on "
                         "(default: cuda)")
    args = ap.parse_args(argv)

    compiled = cfa.compile(
        args.program, tuple(args.space), target=args.target,
        layout=args.layout, backend=args.backend, storage=args.storage,
        n_ports=args.n_ports, trace=True, device=args.device,
    )
    compiled(seeded_inputs(args.program, tuple(args.space), args.seed))
    rec = compiled.last_trace()
    trace = rec.to_chrome()

    if args.out is not None:
        rec.save_chrome(args.out)
        print(f"wrote {args.out} ({len(trace['traceEvents'])} events)",
              file=sys.stderr)
    else:
        json.dump(trace, sys.stdout, indent=1)
        print()

    if args.summary:
        print(f"{rec.label}: {len(rec.spans)} spans, "
              f"counters={json.dumps(rec.counters.as_dict(), sort_keys=True)}",
              file=sys.stderr)

    if args.validate:
        problems = validate_chrome_trace(trace)
        for p in problems:
            print(f"schema: {p}", file=sys.stderr)
        recon = rec.reconcile(compiled.pipeline)
        for m in recon["mismatches"]:
            print(f"reconcile: {m}", file=sys.stderr)
        if problems or not recon["ok"]:
            return 1
        print(f"validated: schema ok, counters reconcile "
              f"({recon['expected']['wire_bytes_read'] + recon['expected']['wire_bytes_write']}"
              f" wire bytes over {recon['expected']['tiles']} tiles)",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
