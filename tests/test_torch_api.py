"""The port's front door (repro_torch.cfa.compile) against repro.cfa.compile.

* every backend of the port (``reference``/``sweep``/``wavefront``/``cuda``,
  on ``device="cpu"``) gives facets bit-exact against the reference's
  ``sweep`` (float64; float32 is pinned per execution path in
  ``test_torch_transform.py``); the port's ``cuda`` backend against the reference's ``pallas``
  to its float tolerance (1e-4 f32 / 1e-12 f64);
* the lowering artifacts — layout key, interior-tile plan burst counts and
  every ``report()`` field — equal the reference's;
* ``layout="autotune"`` picks the reference's candidate, and a layout the
  reference chose runs in the port through ``repro_torch.interop``;
* a traced run reconciles exactly; the default ``device="cuda"`` raises
  without a card; the options the port once rejected (``verify``,
  measured reports and searches, ``diagnostics``, ``runtime_report``) run,
  and the reference's ``pallas`` backend is not in the port's registry;
* the public surface equals the reference's, with ``H100_HBM3`` in place
  of ``TPU_V5E_HBM``, and the target registry holds ``axi-zc706`` and
  ``h100-hbm3``.
"""
import dataclasses
import functools

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax  # noqa: F401  (both frameworks in one process)
import jax.numpy as jnp

from repro import cfa as jcfa
from repro_torch import cfa
from repro_torch.interop import candidate_from_key, facets_to_numpy

CASES = [
    ("jacobi2d5p", (8, 8, 8), (4, 4, 4)),
    ("jacobi2d9p", (8, 8, 8), (4, 4, 4)),
    ("jacobi2d9p-gol", (8, 8, 8), (4, 4, 4)),
    ("gaussian", (4, 16, 16), (2, 8, 8)),
    ("smith-waterman-3seq", (9, 8, 8), (3, 4, 4)),
    ("heat1d", (8, 8), (4, 4)),
    ("heat3d", (4, 4, 4, 4), (2, 2, 2, 2)),
]
CASE = {c[0]: c for c in CASES}
IDS = [c[0] for c in CASES]
THREE_D = [c[0] for c in CASES if len(c[1]) == 3]


@pytest.fixture(autouse=True)
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)  # torch's default


def _inputs(name, seed=0):
    _, space, _ = CASE[name]
    w0 = cfa.get_program(name).widths[0]
    return np.random.default_rng(seed).normal(size=(w0, *space[1:]))


@functools.lru_cache(maxsize=None)
def _jax_facets(name, backend, dtype):
    _, space, tile = CASE[name]
    compiled = jcfa.compile(name, space, layout=tile, backend=backend)
    out = compiled(jnp.asarray(_inputs(name)), dtype=getattr(jnp, dtype))
    return {int(k): np.asarray(v) for k, v in out.items()}


def _port(name, backend="auto", **kw):
    _, space, tile = CASE[name]
    return cfa.compile(name, space, layout=tile, backend=backend, device="cpu", **kw)


def _backend_params():
    out = []
    for name, space, _ in CASES:
        for backend in ("reference", "sweep", "wavefront", "cuda"):
            if backend == "cuda" and len(space) != 3:
                continue
            # float32 bit-exactness of every execution path is pinned in
            # test_torch_transform.py; here one dtype keeps the reference
            # runs few
            out.append(pytest.param(name, backend, "float64",
                                    id=f"{name}-{backend}-float64"))
    return out


@pytest.mark.parametrize("name,backend,dtype", _backend_params())
def test_backends_bit_exact_against_reference_sweep(name, backend, dtype):
    compiled = _port(name, backend)
    assert compiled.backend == backend and compiled.device == torch.device("cpu")
    got = facets_to_numpy(compiled(_inputs(name), dtype=getattr(torch, dtype)))
    want = _jax_facets(name, "sweep", dtype)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"facet {k}")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", THREE_D)
def test_cuda_backend_against_reference_pallas(name, dtype):
    got = facets_to_numpy(_port(name, "cuda")(_inputs(name), dtype=getattr(torch, dtype)))
    want = _jax_facets(name, "pallas", dtype)
    tol = 1e-4 if dtype == "float32" else 1e-12
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol)


@pytest.mark.parametrize("name", IDS)
def test_lowering_artifacts_match_reference(name):
    _, space, tile = CASE[name]
    mine = _port(name)
    ref = jcfa.compile(name, space, layout=tile)
    assert mine.backend == ("cuda" if len(space) == 3 else "wavefront")
    assert ref.backend == ("pallas" if len(space) == 3 else "wavefront")
    assert mine.layout.key == ref.layout.key
    assert mine.plan.read_runs == ref.plan.read_runs
    assert mine.plan.write_runs == ref.plan.write_runs
    assert mine.plan.n_bursts == ref.plan.n_bursts
    assert dataclasses.asdict(mine.report()) == dataclasses.asdict(ref.report())
    assert [t.name for t in mine.trace()] == [t.name for t in ref.trace()]
    assert mine.rehydrate(d := {0: torch.zeros(1)}) is d
    assert name in mine.describe()


def test_autotune_picks_the_reference_candidate(tmp_path):
    name, space = "jacobi2d5p", (16, 32, 32)
    kw = dict(budget=24)
    mine = cfa.compile(name, space, device="cpu",
                       autotune_kwargs=dict(kw, cache_dir=tmp_path / "torch"))
    ref = jcfa.compile(name, space,
                       autotune_kwargs=dict(kw, cache_dir=tmp_path / "jax"))
    assert mine.layout.key == ref.layout.key
    assert mine.decision.evaluated == ref.decision.evaluated
    assert ([s.candidate.key for s in mine.decision.ranked]
            == [s.candidate.key for s in ref.decision.ranked])
    # the decision came from the port's own cache on a second call
    again = cfa.compile(name, space, device="cpu",
                        autotune_kwargs=dict(kw, cache_dir=tmp_path / "torch"))
    assert again.decision.from_cache and again.layout == mine.layout
    # a layout the reference chose runs in the port, bit-exact
    c = ref.layout
    cand = candidate_from_key(c.tile, c.ext_dirs, c.contiguity)
    assert cand.key == c.key
    x = np.random.default_rng(1).normal(size=(1, *space[1:]))
    got = facets_to_numpy(cfa.compile(name, space, layout=cand, device="cpu",
                                      backend="cuda")(x, dtype=torch.float64))
    want = jcfa.compile(name, space, layout=c, backend="sweep")(
        jnp.asarray(x), dtype=jnp.float64)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


@pytest.mark.parametrize("backend", ["sweep", "wavefront", "cuda"])
def test_traced_run_reconciles(backend):
    compiled = _port("jacobi2d5p", backend, trace=True)
    compiled(_inputs("jacobi2d5p"), dtype=torch.float64)
    rec = compiled.last_trace()
    assert rec is not None and rec.meta["device"] == "cpu"
    result = rec.reconcile(compiled.pipeline)
    assert result["ok"], result["mismatches"]
    assert rec.counters["tiles"] == 8 and rec.counters["waves"] == 4
    assert not cfa.validate_chrome_trace(rec.to_chrome())
    # tracing off: no recorder left behind on the pipeline
    assert compiled.pipeline.recorder is None


def test_default_device_is_cuda_and_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the no-card behaviour")
    with pytest.raises(RuntimeError, match="CUDA device"):
        cfa.compile("jacobi2d5p", (8, 8, 8), layout=(4, 4, 4))(_inputs("jacobi2d5p"))


@pytest.mark.parametrize("kw,backend", [
    (dict(n_ports=2), "sharded"), (dict(overlap=True), "dataflow"),
    (dict(halo_quantize=True), "cuda"), (dict(verify=True), "cuda"),
], ids=["n_ports", "overlap", "halo_quantize", "verify"])
def test_unported_options_raise(kw, backend):
    """Every option the port once rejected now compiles: the multi-port,
    dataflow and halo-quantize options to their backends, and ``verify``
    to the auto backend with the analysis report attached."""
    compiled = _port("jacobi2d5p", **kw)
    assert compiled.backend == backend
    assert compiled.pipeline.halo_quantize == kw.get("halo_quantize", False)
    assert compiled.n_ports == kw.get("n_ports", 1)
    if kw.get("verify"):
        report = compiled.diagnostics()
        assert report is compiled.analysis and report.ok
        assert [a for a, _ in report.analyses] == [
            "verify_single_assignment", "verify_overlap", "lint_bursts", "verify_contracts"]
    else:
        assert compiled.analysis is None


def test_unported_backends_and_methods_raise():
    """Only the reference's ``pallas`` backend is missing from the port (its
    ``cuda`` backend stands in); the measured and analysis methods run on
    the stencil's device, here the CPU."""
    compiled = _port("jacobi2d5p")
    with pytest.raises(cfa.BackendError, match="unknown backend"):
        compiled.lower("pallas")
    for backend in ("sharded", "dataflow"):
        assert compiled.lower(backend).backend == backend
    with pytest.raises(cfa.BackendError, match="3-D spaces only"):
        _port("heat1d", "cuda")
    measured = dict(warmup=1, repeats=3)
    rep = compiled.report(measured=True, **measured)
    assert rep.measured_time_s > 0 and rep.model_error is not None
    assert compiled.diagnostics().ok and compiled.diagnostics().codes == ("CFA303",)
    rows = compiled.runtime_report(**measured).rows
    assert rows and all(r.observed_s > 0 for r in rows)
    d = cfa.autotune("jacobi2d5p", (8, 8, 8), score="measured", measure_top=2, cache=False,
                     measure_kwargs=dict(device="cpu", **measured))
    assert sum(s.measured_time_s is not None for s in d.ranked) == 2
    # the storage disciplines run: the codec is no longer a stub
    assert torch.equal(cfa.get_codec("deltapack16").roundtrip(torch.zeros(4)), torch.zeros(4))
    assert "tpu-v5e-hbm" not in cfa.TARGETS
    assert list(cfa.TARGETS) == ["axi-zc706", "h100-hbm3"]
    assert sorted(cfa.EXECUTORS) == ["cuda", "dataflow", "reference", "sharded", "sweep",
                                     "wavefront"]


def test_public_surface_is_a_subset_of_the_reference():
    """Every public name but the port's own device preset is the reference's."""
    assert set(cfa.__all__) - {"H100_HBM3"} <= set(jcfa.__all__)
    assert {"compile", "CompiledStencil", "CFAPipeline", "autotune"} <= set(cfa.__all__)


def test_public_surface_equals_the_reference():
    assert set(cfa.__all__) == set(jcfa.__all__) - {"TPU_V5E_HBM"} | {"H100_HBM3"}
    from repro.core import cfa as jcore
    from repro_torch.core import cfa as core

    assert set(core.__all__) == set(jcore.__all__) - {"TPU_V5E_HBM"} | {"H100_HBM3"}


def test_h100_target_is_registered_with_its_fitted_model():
    target = cfa.get_target("h100-hbm3")
    assert target.model is cfa.H100_HBM3 and target.max_ports == 5
    assert "HBM3" in target.description
    m = cfa.H100_HBM3
    assert m.elem_bytes == 4 and m.setup_s > 0 and 0 < m.peak_bytes_per_s < 3.35e12
    assert cfa.get_target(m) is target and cfa.get_target("axi-zc706").model is cfa.AXI_ZC706
    compiled = _port("jacobi2d5p", target="h100-hbm3", verify=True)
    assert compiled.target is target and compiled.report().model == "h100-hbm3"
    with pytest.raises(ValueError, match="memory port"):
        _port("jacobi2d5p", target="h100-hbm3", n_ports=6, backend="sharded")
    # the default target stays the paper's, as in the reference
    assert _port("jacobi2d5p").target.name == "axi-zc706"
