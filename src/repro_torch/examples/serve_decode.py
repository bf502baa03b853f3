"""Serving example: batched requests through prefill + facet-layout KV-cache
decode, with per-phase throughput accounting.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode --arch qwen3-0.6b   # on the card
    PYTHONPATH=src python -m repro_torch.examples.serve_decode --device cpu --gen 4

Delegates to ``python -m repro_torch.launch.serve --smoke`` (the same entry
point a deployment uses), which prints each kernel's launches: on the card
``decode_attention`` runs once per attention layer per decode tick.
"""
from __future__ import annotations

import argparse
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="torch device the model runs on (default: cuda)")
    args = ap.parse_args(argv)
    code = subprocess.call([
        sys.executable, "-m", "repro_torch.launch.serve", "--arch", args.arch,
        "--smoke", "--batch", str(args.batch), "--gen", str(args.gen),
        "--device", args.device,
    ])
    if code == 0:
        print("OK")
    return code


if __name__ == "__main__":
    raise SystemExit(main())
