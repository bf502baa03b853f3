"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell names a configuration
(``bench/configs/<name>.json``) and a traffic mix
(``bench/traffic/<name>.json``); the mix names its driver
(``bench/drivers/<name>.py``), which loads the program from ``src/``, sets
it up, runs the measured window and checks what the window produced against
the plain reference.  With ``--trace 0`` the result carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, each read from
the traced window by ``bench/metrics/<metric>.py``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each number compared beside its limit,
which also end standard error).  Without a CUDA device, with fewer devices
than the cell asks for, without ``src/repro_torch`` beside ``bench/``, or
with JAX or the JAX package loaded, it prints no result and exits non-zero.
"""
from __future__ import annotations

import os
import time


def _process_start() -> float:
    """``time.perf_counter()``'s reading at this process's start (from
    ``/proc``; this module's import where that cannot be read)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that must not be loaded in the process that
#: prints the result (the JAX package is ``repro``; the port, ``repro_torch``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    workload: str
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float


def _args(argv):
    p = argparse.ArgumentParser(prog="python3 -m bench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def per_layer(cell: dict, trace) -> dict:
    """The cell's per-layer metrics that its trace holds something for."""
    from bench import registry

    out = {}
    for m in registry.cell_metrics("per_layer", cell["name"]):
        value = registry.metric_reader(m["name"])(trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = _args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"bench: no program at {ROOT / 'src' / 'repro_torch'}", file=sys.stderr)
        return 2
    for path in (str(ROOT / "src"), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)
    from bench import registry

    cell = registry.workload(args.workload)
    config, mix = registry.config(cell["config"]), registry.traffic(cell["traffic"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"bench: {cell['name']} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    print(f"bench: {cell['name']} seed {args.seed} on {cell['chips']} of "
          f"{torch.cuda.device_count()} x {kind}", file=sys.stderr)
    run = Run(workload=cell["name"], config=config, mix=mix, seed=args.seed,
              seconds=args.seconds, trace=bool(args.trace), device="cuda", t_start=T_START)
    out = registry.driver(mix["driver"]).run(run)

    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]),
              "failed": int(out["failed"])}
    if args.trace:
        trace = out["trace"]
        result["metrics"] = per_layer(cell, trace)
        device.update(busy_s=trace.busy_s(), window_s=trace.window_s)
        result["device"] = device
        result["breakdown"] = trace.breakdown()
    else:
        result["metrics"] = {
            m["name"]: {"value": out["metrics"][registry.quantity(m["name"], out["metrics"])],
                        "unit": m["unit"]}
            for m in registry.cell_metrics("end_to_end", cell["name"])}
        result["device"] = device
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in out["checks"].items()}

    bad = forbidden_modules()
    if bad:
        print(f"bench: the process holds {bad} (JAX or the JAX package); no result", file=sys.stderr)
        return 3
    print(f"bench: notes {json.dumps(out.get('notes', {}))}", file=sys.stderr)
    for name, (value, limit) in out["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
