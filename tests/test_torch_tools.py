"""The port's CLIs (``python -m repro_torch.tools.{cfa_lint,cfa_trace,
dump_pipeline}``, run here through their ``main`` with ``--device cpu``)
against the reference's ``tools/*.py``, loaded as ``tests/test_analysis.py``
loads them, and ``stencil_tile_op`` against the reference's.

* ``cfa_lint --json`` over the default matrix with ``--include-baselines``,
  and without it over two programs, and its text mode: the same findings
  and exit codes.  The port's kernel backend is registered as ``cuda``
  where the reference's is ``pallas``: that one field is mapped.
* ``dump_pipeline jacobi2d5p 8 8 8 --layout 4,4,4 --host-budget 2000
  --verify``: the reference's per-pass JSON with the wall times dropped
  (``IGNORED``), and ``"n_ports": 2, "distributed": true, "backend":
  "sharded"``.
* ``cfa_trace jacobi2d5p 8 8 8 --layout 4,4,4 --backend {sweep,dataflow}
  --validate --summary``: schema and counter reconciliation pass, and the
  summary's counters equal the reference tool's.
* ``stencil_tile_op`` with ``use_kernel`` true and false for all 7
  programs at a small tile: bit for bit the reference's jnp oracle
  (``use_kernel=False``); with ``use_kernel`` also within 1e-4 of the
  reference's Pallas kernel in interpret mode, which re-associates and is
  itself 1 ulp off its oracle on 5 of the 7 programs.
"""
import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.stencil.ops import stencil_tile_op as jax_stencil_tile_op
from repro_torch.core.cfa.programs import PROGRAMS, get_program
from repro_torch.kernels.stencil import stencil_tile_op
from repro_torch.tools import cfa_lint, cfa_trace, dump_pipeline

TOOLS = Path(__file__).resolve().parents[1] / "tools"
#: the port's registry name of the kernel backend -> the reference's
BACKEND_NAMES = {"cuda": "pallas"}
#: per-pass fields dropped before comparing ``dump_pipeline``'s JSON: host wall times
IGNORED = ("wall_s",)


@pytest.fixture(autouse=True)
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)  # torch's default


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(f"ref_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv, capsys) -> tuple[int, str, str]:
    code = main(argv)
    out = capsys.readouterr()
    return code, out.out, out.err


def _lint_entries(doc: dict) -> dict:
    for e in doc["entries"]:
        e["backend"] = BACKEND_NAMES.get(e["backend"], e["backend"])
    return doc


@pytest.mark.parametrize("argv", [
    ["--json", "--include-baselines"],
    ["jacobi2d5p", "heat1d", "--json"],
    ["jacobi2d5p", "heat1d", "--json", "--strict", "--storages", "redundant"],
], ids=["matrix-baselines", "two-programs", "strict"])
def test_cfa_lint_json_matches_the_reference(argv, capsys):
    ref_code, ref_out, _ = _run(_load_tool("cfa_lint").main, argv, capsys)
    code, out, _ = _run(cfa_lint.main, [*argv, "--device", "cpu"], capsys)
    assert code == ref_code
    got, want = _lint_entries(json.loads(out)), json.loads(ref_out)
    assert got == want
    assert got["entries"] and got["exit_code"] == code


def test_cfa_lint_text_mode_matches_the_reference(capsys):
    argv = ["jacobi2d5p", "heat1d", "--include-baselines"]
    ref_code, ref_out, _ = _run(_load_tool("cfa_lint").main, argv, capsys)
    code, out, _ = _run(cfa_lint.main, [*argv, "--device", "cpu"], capsys)
    assert code == ref_code
    assert "combination(s) linted" in out
    for port, ref in BACKEND_NAMES.items():
        out = out.replace(f", {port}]", f", {ref}]")
    assert out == ref_out


def _strip(doc: dict) -> dict:
    for p in doc["passes"]:
        for k in IGNORED:
            p.pop(k)
    return doc


def test_dump_pipeline_matches_the_reference(capsys):
    argv = ["jacobi2d5p", "8", "8", "8", "--layout", "4,4,4", "--host-budget", "2000",
            "--verify"]
    ref_code, ref_out, _ = _run(_load_tool("dump_pipeline").main, argv, capsys)
    code, out, _ = _run(dump_pipeline.main, [*argv, "--device", "cpu"], capsys)
    assert code == ref_code == 0
    got, want = _strip(json.loads(out)), _strip(json.loads(ref_out))
    assert got == want
    assert {k: got["compiled"][k] for k in ("n_ports", "distributed", "backend")} == {
        "n_ports": 2, "distributed": True, "backend": "sharded"}
    assert "analysis" in got


def _counters(err: str) -> dict:
    m = re.search(r"counters=(\{.*\})", err)
    assert m, err
    return json.loads(m.group(1))


@pytest.mark.parametrize("backend", ["sweep", "dataflow"])
def test_cfa_trace_validates_and_counts_as_the_reference(backend, tmp_path, capsys):
    argv = ["jacobi2d5p", "8", "8", "8", "--layout", "4,4,4", "--backend", backend,
            "--validate", "--summary"]
    ref_code, _, ref_err = _run(_load_tool("cfa_trace").main,
                                [*argv, "-o", str(tmp_path / "ref.json")], capsys)
    code, _, err = _run(cfa_trace.main,
                        [*argv, "-o", str(tmp_path / "port.json"), "--device", "cpu"], capsys)
    assert code == ref_code == 0, err
    assert "validated: schema ok, counters reconcile" in err
    assert _counters(err) == _counters(ref_err)
    trace = json.loads((tmp_path / "port.json").read_text())
    assert trace["traceEvents"]


def _halos(name, tile, batch, seed):
    w = get_program(name).widths
    shape = (batch, *(wa + ta for wa, ta in zip(w, tile)))
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
@pytest.mark.parametrize("use_kernel", [True, False])
def test_stencil_tile_op_matches_the_reference(name, use_kernel):
    tile = tuple(2 for _ in get_program(name).widths)
    h = _halos(name, tile, 3, 7)
    got = stencil_tile_op(name, torch.from_numpy(h), tile, use_kernel=use_kernel)
    assert got.shape == (3, *tile) and got.dtype == torch.float32
    # on a CPU tensor the wrapper runs the kernel's plain version: bit for
    # bit the reference's jnp oracle
    oracle = np.asarray(jax_stencil_tile_op(name, jnp.asarray(h), tile, use_kernel=False))
    np.testing.assert_array_equal(got.numpy(), oracle)
    if use_kernel:
        # the reference's Pallas kernel re-associates (XLA): within
        # tests/test_kernels.py's float32 tolerance, as test_torch_stencil.py holds it
        pallas = np.asarray(jax_stencil_tile_op(name, jnp.asarray(h), tile, use_kernel=True))
        np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-4, atol=1e-4)
