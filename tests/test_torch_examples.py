"""The port's examples (``python -m repro_torch.examples.<name>``, run here
with ``--device cpu``) against the reference's ``examples/*.py``, loaded by
path as ``tests/test_analysis.py`` loads the reference tools.

* ``quickstart``: the printed plan numbers (bursts/tile, redundancy, the AXI
  effective bandwidth of the compiled layout and both baselines) and the
  autotuned layout key equal the reference quickstart's, each package with
  a scratch autotune cache; the port's ``sweep`` facets and its ``cuda``
  backend's facets equal the reference's ``sweep`` facets bit for bit.
* ``stencil_pipeline``: the ``cuda`` backend's facets and ``wavefront``'s
  equal the reference's ``wavefront`` facets bit for bit.
* ``serve_decode --gen 4``: exit 0, ``OK`` last.
* ``train_lm``: ``CFG_100M`` equal to the reference's field for field, with
  the same ``param_count()``; ``run()`` at a 2-layer, d 64 cut for 4 steps,
  stopped by the ``PREEMPT`` sentinel after step 2 and rerun, gives the
  uninterrupted run's losses at steps 3 and 4 bit for bit.
* ``pipeline_parallel``: 4 gloo ranks, err < 1e-5, bubble 3/11.
* Without ``--device`` every example raises here (no card), and none prints
  ``OK``.
"""
import dataclasses
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax  # noqa: F401  (the reference examples run on JAX's CPU backend)

from repro_torch.examples import (pipeline_parallel, quickstart, serve_decode,
                                  stencil_pipeline, train_lm)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
#: a quickstart burst-table row: name, bursts/tile, redundancy %, AXI effective bw %
ROW = re.compile(r"^\s*(.+?):\s+(\d+) bursts/tile, redundancy\s+([\d.]+)%, "
                 r"effective bw\s+([\d.]+)% \(AXI\)", re.M)
LAYOUT = re.compile(r"^autotuned layout: (\S+)", re.M)


def _load_example(name: str):
    """Run the reference example ``examples/<name>.py`` (its module body is
    the script) and return the module with its globals."""
    spec = importlib.util.spec_from_file_location(f"ref_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_facets(got: dict, want: dict) -> bool:
    return set(got) == set(want) and all(
        np.array_equal(got[k].cpu().numpy(), np.asarray(want[k])) for k in want)


@pytest.fixture
def subprocess_env(monkeypatch):
    """The children the examples start import the port from ``src/``."""
    monkeypatch.setenv("PYTHONPATH", str(ROOT / "src"))


def test_quickstart_matches_the_reference(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax"))
    ref = _load_example("quickstart")
    ref_out = capsys.readouterr().out
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "torch"))
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    got = quickstart.quickstart("cpu")  # the cached decision now: the same layout
    rows, ref_rows = ROW.findall(out), ROW.findall(ref_out)
    assert [r[0] for r in rows] == ["CFA (compiled)", "original", "bounding-box"]
    assert rows == ref_rows
    assert LAYOUT.findall(out) == LAYOUT.findall(ref_out) == [ref.compiled.layout.key]
    assert got["compiled"].layout.key == ref.compiled.layout.key
    assert got["compiled"].backend == "cuda" and got["launches"] == 0  # the plain version
    assert _same_facets(got["sweep"], ref.sweep)
    assert _same_facets(got["facets"], ref.sweep)
    assert out.rstrip().splitlines()[-2].startswith("stencil_tiles launches: 0")
    assert out.rstrip().splitlines()[-1] == "OK"


def test_stencil_pipeline_matches_the_reference(capsys):
    ref = _load_example("stencil_pipeline")
    capsys.readouterr()
    assert stencil_pipeline.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    got = stencil_pipeline.stencil_pipeline("cpu")
    assert _same_facets(got["facets"], ref.wave)
    assert _same_facets(got["wavefront"], ref.wave)
    assert got["waves"] == 4 and got["err"] < 1e-4
    assert out.rstrip().splitlines()[-1] == "OK"


def test_serve_decode_runs_the_launcher(subprocess_env, capfd):
    assert serve_decode.main(["--device", "cpu", "--gen", "4"]) == 0
    out = capfd.readouterr().out
    assert "decode: 4x4 tokens" in out
    assert "kernel launches: decode_attention 0, ssd_scan 0 (3 decode steps)" in out
    assert out.rstrip().splitlines()[-1] == "OK"


def test_train_lm_config_is_the_reference_s():
    ref = _load_example("train_lm")
    # every field the reference's configuration has is equal; the port's own
    # fields (an expert share, NoPE, the muP multipliers, ...) hold their
    # defaults, which change nothing
    shared = dataclasses.asdict(ref.CFG_100M)
    got = dataclasses.asdict(train_lm.CFG_100M)
    assert {k: v for k, v in got.items() if k in shared} == shared
    assert {k: v for k, v in got.items() if k not in shared} == {
        f.name: f.default for f in dataclasses.fields(train_lm.CFG_100M) if f.name not in shared}
    assert train_lm.CFG_100M.param_count() == ref.CFG_100M.param_count() == 125829120


#: the 2-layer, d 64 cut of ``CFG_100M`` the resume test trains
CUT = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128, vocab=512, head_dim=32)


def test_train_lm_resumes_bit_equal(tmp_path, monkeypatch, capsys):
    cfg = dataclasses.replace(train_lm.CFG_100M, **CUT)
    kw = dict(steps=4, batch=2, seq=32, device="cpu", log_every=1)
    straight = train_lm.run(cfg, ckpt_dir=str(tmp_path / "straight"), **kw)
    assert (straight["start"], straight["end"]) == (0, 4)

    ckpt = tmp_path / "resumed"
    sentinel = ckpt / "PREEMPT"

    class PreemptAfterTwo(train_lm.PackedDocs):
        """Raises the sentinel while step 2 is served: the trainer stops
        after step 2 and checkpoints it."""

        def next(self, deadline_s=None):
            batch = super().next(deadline_s)
            if self.step == 2:
                sentinel.touch()
            return batch

    monkeypatch.setattr(train_lm, "PackedDocs", PreemptAfterTwo)
    first = train_lm.run(cfg, ckpt_dir=str(ckpt), **kw)
    assert (first["start"], first["end"]) == (0, 2)
    monkeypatch.undo()
    sentinel.unlink()
    second = train_lm.run(cfg, ckpt_dir=str(ckpt), **kw)  # the same command again
    assert (second["start"], second["end"]) == (2, 6)
    want = {m["step"]: m["loss"] for m in straight["log"]}
    got = {m["step"]: m["loss"] for m in first["log"] + second["log"]}
    assert [got[s] for s in (1, 2, 3, 4)] == [want[s] for s in (1, 2, 3, 4)]
    assert all(np.isfinite(v) for v in got.values())
    assert "peak max_memory_allocated not measured off the card" in capsys.readouterr().out


def test_pipeline_parallel_runs_four_gloo_ranks(subprocess_env, capfd):
    assert pipeline_parallel.main(["--device", "cpu"]) == 0
    out = capfd.readouterr().out
    err = float(re.search(r"err=(\S+),", out).group(1))
    assert err < 1e-5
    assert "4-stage pipeline over 8 microbatches" in out
    assert "(S-1)/(M+S-1) = 3/11" in out
    assert out.rstrip().splitlines()[-1] == "OK"


@pytest.mark.parametrize("example,argv", [
    (quickstart, []), (stencil_pipeline, []), (train_lm, ["--steps", "1"]),
    (pipeline_parallel, []),
], ids=["quickstart", "stencil_pipeline", "train_lm", "pipeline_parallel"])
def test_examples_default_to_the_card(example, argv, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        example.main([*argv, "--ckpt-dir", str(tmp_path)] if example is train_lm else argv)
    assert "OK" not in capsys.readouterr().out


def test_serve_decode_defaults_to_the_card(subprocess_env, capfd):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    assert serve_decode.main(["--gen", "2"]) != 0
    out = capfd.readouterr()
    assert "needs a CUDA device" in out.err and "OK" not in out.out
