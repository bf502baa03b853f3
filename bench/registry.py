"""Finds the benchmark's pieces by name: ``BENCHMARK.json`` at the root of
the checkout, and under ``bench/`` one file per configuration
(``configs/<name>.json``), traffic mix (``traffic/<name>.json``), kind of
work (``drivers/<name>.py``), plain reference (``reference/<name>.py``,
whose ``leaf_specs(arch)``, where it defines one, lists the configuration's
weights: :func:`bench.inputs.config_specs`) and per-layer metric
(``metrics/<name>.py``).  A later cell, mix, model or metric is a new file
and a new entry; nothing here names one.

A quantity that cells of different pace report under metrics of their own
(each with its own bound, or moving its own end-to-end metric) is named
``<quantity>.<part>``: such a metric is read as its quantity, by the
longest dotted prefix of its name that a driver returns or that has a
reader, unless it has a reader of its own.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

__all__ = ["BENCH", "ROOT", "benchmark", "workload", "config", "traffic", "module",
           "driver", "reference", "metric_reader", "quantity", "cell_metrics"]


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(name: str) -> dict:
    for cell in benchmark()["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` loaded under a private module name (a name
    may hold dots and dashes)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"bench._{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return module("drivers", name)


def reference(name: str):
    return module("reference", name)


def quantity(name: str, have) -> str:
    """The longest dotted prefix of the metric ``name`` (itself first) that
    is in ``have``."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        if ".".join(parts[:n]) in have:
            return ".".join(parts[:n])
    raise KeyError(f"nothing reads metric {name!r}: none of its prefixes is in {sorted(have)}")


def metric_reader(name: str):
    """The metric's ``read(trace) -> float | None``: ``metrics/<name>.py``,
    or that of its quantity."""
    readers = {p.stem for p in (BENCH / "metrics").glob("*.py")}
    return module("metrics", quantity(name, readers)).read


def cell_metrics(kind: str, cell: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that the cell reports:
    those that list it under ``workloads``, and those that list no cells."""
    return [m for m in benchmark()[kind] if cell in m.get("workloads", [cell])]
