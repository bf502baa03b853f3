"""The benchmark's files: found by name, named within the contract's
characters, and kept apart from JAX, the JAX package and (for the plain
reference) the program."""
from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from bench import registry

BENCH = registry.BENCH
SPEC = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def _imports(path: Path) -> set[str]:
    """Top-level names of every module a Python file imports (relative
    imports of this package count as ``bench``)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("bench" if node.level else node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("cell", CELLS)
def test_every_piece_of_a_cell_is_found_by_name(cell):
    w = registry.workload(cell)
    config, mix = registry.config(w["config"]), registry.traffic(w["traffic"])
    assert callable(registry.driver(mix["driver"]).run)
    assert callable(registry.reference(config["reference"]).train_steps)
    for m in SPEC["per_layer"]:
        if cell in m.get("workloads", CELLS):
            assert callable(registry.metric_reader(m["name"]))
    assert {c["name"]: c["file"] for c in SPEC["configs"]}[w["config"]] == \
        f"bench/configs/{w['config']}.json"


def test_names_units_and_keys_keep_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [m["name"] for m in METRICS]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names)) == len(names)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all(1 <= len(layer) <= 200 and "\n" not in layer for layer in layers)
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert set(m.get("workloads", [])) <= set(CELLS)
    for cell in CELLS:  # each cell reports setup_s, another end-to-end metric, a per-layer one
        e2e = {m["name"] for m in registry.cell_metrics("end_to_end", cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = registry.cell_metrics("per_layer", cell)
        assert per_layer and all(m["moves"] in e2e for m in per_layer), cell
    for c in SPEC["workloads"]:
        assert c["chips"] in (1, 4) and len(c["why"]) <= 200
        assert NAME.match(c["config"]) and NAME.match(c["traffic"])
    used = {c["config"] for c in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert set(c["reduced"]) == set(registry.config(c["name"])["reduced"])
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_a_split_metric_is_read_as_its_quantity(cell):
    """``train_tokens_per_s.moe`` is the train driver's ``train_tokens_per_s``
    and ``launches_per_step.train.moe`` reads by
    ``metrics/launches_per_step.train.py``; a name with no prefix to read
    it raises."""
    have = {"train_tokens_per_s", "setup_s"}
    for m in registry.cell_metrics("end_to_end", cell):
        assert registry.quantity(m["name"], have) in have
    assert registry.quantity("launches_per_step.train.moe", {"launches_per_step.train"}) == \
        "launches_per_step.train"
    assert registry.quantity("a.b", {"a.b", "a"}) == "a.b"
    assert registry.metric_reader("launches_per_step.train.moe") is not None
    with pytest.raises(KeyError):
        registry.quantity("tokens_per_s.moe", have)


def test_file_names_under_paths_are_made_of_name_characters():
    for path in BENCH.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(registry.ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_nothing_under_bench_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        found = _imports(path) & {"jax", "jaxlib", "flax", "repro"}
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "repro_torch" not in _imports(path), path
    assert "repro_torch" not in _imports(BENCH / "inputs.py")


def test_the_import_scan_compares_whole_top_level_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.models\nfrom repro.core import x\nimport jaxtyping\n")
    assert _imports(f) == {"repro_torch", "repro", "jaxtyping"}
