"""Readings that a cell's correctness limits are set from, at the cell's own
size, on the card, in one process:

    python3 -m bench.limits --workload <cell> --seeds 1 2 3 ... \
        [--modes program control half_batch bf16 dloga_fault dbc_fault] [--out FILE]

For every seed the plain reference runs the cell's checked steps in float32,
then each mode is compared with it by :func:`bench.drivers.train.gaps`:

* ``program`` — the program's own steps, set up exactly as a run sets them
  up (the lower readings);
* ``control`` — the reference put in the program's place, computing in
  float8 (e4m3, the precision below the configurations' bfloat16; the upper
  readings);
* ``half_batch`` — the reference put in the program's place, training on
  half of every batch (a fault a training cell can have);
* ``bf16`` — the reference put in the program's place, rounding to
  bfloat16 where the program computes in it (a witness of what the
  configuration's compute type alone does, not a control);
* ``dloga_fault``, ``dbc_fault`` — the program with ``ssd_scan_bwd``'s
  gradient of the log-decay, or of B and C, scaled by ``--fault-scale``
  (faults confined to the state-space leaves and what they feed).

A state left unchanged reads 1 by the update gap and needs no run.  One JSON
line per seed and mode goes to standard output and, with every reading of
both sides added, to ``--out``.  The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: planted faults: which of ``ssd_scan_bwd``'s (dx, dloga, dB, dC) are scaled
FAULTS = {"dloga_fault": (1,), "dbc_fault": (2, 3)}


def _program(config, mix, seed, fault=None, scale=0.9) -> dict:
    """The program's readings of the checked steps, set up as a run sets
    them up; with ``fault``, ``ssd_scan_bwd`` wrapped to scale the named
    gradients by ``scale``."""
    import tempfile

    from bench.drivers import train
    from repro_torch.kernels.ssd import ssd

    real = ssd.ssd_scan_bwd

    def broken(*args, **kwargs):
        return tuple(g * scale if i in FAULTS[fault] else g
                     for i, g in enumerate(real(*args, **kwargs)))

    broken.launches = 0  # the wrapper counts its calls on the name it is called by
    if fault:
        ssd.ssd_scan_bwd = broken
    try:
        with tempfile.TemporaryDirectory() as ckpt:
            trainer = train.make_trainer(config, mix, seed, "cuda", ckpt)
            got, _ = train.program_readings(trainer, config, mix, seed)
            trainer.data.close()
            del trainer
            train._free("cuda")
    finally:
        ssd.ssd_scan_bwd = real
    return got


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m bench.limits")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--modes", nargs="+", default=["program", "control", "half_batch"],
                   choices=["program", "control", "half_batch", "bf16", *FAULTS])
    p.add_argument("--fault-scale", type=float, default=0.9)
    p.add_argument("--out", default=None,
                   help="a file to append each line to, with every reading of both sides")
    args = p.parse_args(argv)
    for path in (str(ROOT / "src"), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch

    from bench import registry
    from bench.drivers import train

    if not torch.cuda.is_available():
        print("bench.limits: no CUDA device", file=sys.stderr)
        return 2
    cell = registry.workload(args.workload)
    config, mix = registry.config(cell["config"]), registry.traffic(cell["traffic"])
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            ref = train.reference_readings(config, mix, seed, "cuda")
            ref_s = time.perf_counter() - t0
            for mode in args.modes:
                t0 = time.perf_counter()
                if mode == "program" or mode in FAULTS:
                    got = _program(config, mix, seed, mode if mode in FAULTS else None,
                                   args.fault_scale)
                else:
                    got = train.reference_readings(
                        config, mix, seed, "cuda",
                        precision={"control": "float8", "bf16": "bfloat16"}.get(mode, "float32"),
                        half_batch=mode == "half_batch")
                line = {"workload": args.workload, "mode": mode, "seed": seed,
                        "fault_scale": args.fault_scale if mode in FAULTS else None,
                        "gaps": train.gaps(got, ref), "loss": got["loss"],
                        "ref_loss": ref["loss"], "grad_norm": got["grad_norm"],
                        "ref_grad_norm": ref["grad_norm"],
                        "seconds": time.perf_counter() - t0, "ref_seconds": ref_s}
                print(json.dumps(line), flush=True)
                if out:
                    out.write(json.dumps(dict(line, got=got, ref=ref)) + "\n")
                    out.flush()
                train._free("cuda")
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
