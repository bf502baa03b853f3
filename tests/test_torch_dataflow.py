"""The port's ``dataflow`` backend against the reference package's.

``CFAPipeline._sweep_dataflow`` overlaps fetch, compute and commit of
consecutive tiles (Fig. 13 DATAFLOW): tile ``j`` computes while ``j+1`` is
gathered and ``j-1`` committed, through a ping-pong pair of halo buffers
(on a card the compute runs on a stream of its own).  It only reorders
work, so on every program and storage discipline its facets equal the
port's ``sweep`` and the reference's ``_sweep_dataflow`` bit for bit, host
and kernel path (on CPU tensors the tile kernel's wrapper runs its plain
version); the reference's interpret-mode kernel path is held within 1e-12.
Its rejections, its capability declaration, ``report()``'s overlapped
default and the concurrent lanes of its trace are the reference's.

Inputs are made with numpy from a seed; facets cross over as numpy.
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
from repro_torch.core.cfa import get_program
from repro_torch.interop import facets_to_numpy
from repro_torch.kernels.stencil import execute_tiles

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
STORAGES = ["redundant", "irredundant", "compressed"]


@pytest.fixture(autouse=True)
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)  # torch's default


def _inputs(name, seed=0):
    _, space, _ = CASE[name]
    w0 = get_program(name).widths[0]
    return np.random.default_rng(seed).normal(size=(w0, *space[1:]))


def _port(name, backend="dataflow", storage="redundant", **kw):
    _, space, tile = CASE[name]
    return cfa.compile(name, space, layout=tile, backend=backend, storage=storage,
                       device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _jax(name, backend, storage, use_kernel=False):
    _, space, tile = CASE[name]
    compiled = jcfa.compile(name, space, layout=tile, backend=backend, storage=storage)
    opts = dict(use_kernel=True) if use_kernel else {}
    out = compiled(jnp.asarray(_inputs(name)), dtype=jnp.float64, **opts)
    return {int(k): np.asarray(v) for k, v in out.items()}


def _assert_facets_equal(got, want):
    got = facets_to_numpy(got)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, f"facet {k}"
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"facet {k}")


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_dataflow_host_path_bit_exact(name, storage):
    """dataflow == the port's sweep == the reference's dataflow, facet for
    facet, on every program and storage discipline."""
    got = _port(name, storage=storage)(_inputs(name), dtype=torch.float64)
    sweep = _port(name, "sweep", storage)(_inputs(name), dtype=torch.float64)
    for k in sweep:
        assert torch.equal(got[k], sweep[k]), f"facet {k}"
    _assert_facets_equal(got, _jax(name, "dataflow", storage))


def _kernel_params():
    return [pytest.param(name, storage, id=f"{name}-{storage}")
            for name, space, _ in CASES if len(space) == 3
            for storage in ("redundant", "irredundant")]


@pytest.mark.parametrize("name,storage", _kernel_params())
def test_dataflow_kernel_path(name, storage):
    """use_kernel=True (one tile-executor call per tile; its plain version
    on CPU tensors) equals the port's sweep bit for bit and the reference's
    Pallas kernel path within 1e-12."""
    before = execute_tiles.launches
    got = _port(name, storage=storage)(_inputs(name), dtype=torch.float64, use_kernel=True)
    assert execute_tiles.launches == before  # plain versions do not count
    sweep = _port(name, "sweep", storage)(_inputs(name), dtype=torch.float64)
    for k in sweep:
        assert torch.equal(got[k], sweep[k]), f"facet {k}"
    want = _jax(name, "dataflow", storage, use_kernel=True)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-12, atol=1e-12)


def test_dataflow_matches_wavefront_and_reference():
    """Three-way agreement: dataflow == wavefront == reference oracle."""
    name = "jacobi2d5p"
    df = _port(name)(_inputs(name), dtype=torch.float64)
    for backend in ("wavefront", "reference"):
        other = _port(name, backend)(_inputs(name), dtype=torch.float64)
        for k in other:
            assert torch.equal(df[k], other[k]), f"{backend} facet {k}"


def test_compile_overlap_selects_dataflow():
    for name, space, _ in CASES:
        compiled = _port(name, "auto", overlap=True)
        assert compiled.backend == "dataflow"
        assert cfa.select_backend(compiled.program, compiled.space, overlap=True) == "dataflow"
    # a sequential backend cannot be asked to overlap
    with pytest.raises(cfa.BackendError, match="pipelines fetch/compute/commit"):
        _port("jacobi2d5p", "sweep", overlap=True)


def test_dataflow_declares_overlap_cap():
    caps = cfa.EXECUTORS["dataflow"].caps
    assert caps.overlap and caps.kernels and not caps.multiport
    assert [n for n, ex in cfa.EXECUTORS.items() if ex.caps.overlap] == ["dataflow"]
    assert caps.storages == ("redundant", "irredundant", "compressed")


def test_dataflow_kernel_path_rejects_non_3d():
    compiled = _port("heat1d")
    with pytest.raises(cfa.BackendError, match=r"3-D.*2-D"):
        compiled(_inputs("heat1d"), dtype=torch.float64, use_kernel=True)


def test_dataflow_kernel_path_rejects_compressed():
    compiled = _port("jacobi2d5p", storage="compressed")
    with pytest.raises(cfa.BackendError, match="decode"):
        compiled(_inputs("jacobi2d5p"), dtype=torch.float64, use_kernel=True)


def test_dataflow_rejects_unknown_options():
    with pytest.raises(TypeError, match="does not accept"):
        _port("jacobi2d5p")(_inputs("jacobi2d5p"), dtype=torch.float64, mesh=None)


def test_dataflow_report_defaults_to_overlap():
    """report() on a dataflow-bound stencil models the pipelined schedule,
    field for field the reference's."""
    name, space, tile = CASE["jacobi2d5p"]
    compiled = _port(name)
    ref = jcfa.compile(name, space, layout=tile, backend="dataflow")
    c = 1e-4
    ovl = compiled.report(compute_s=c)
    seq = compiled.report(compute_s=c, overlap=False)
    assert ovl.overlap and not seq.overlap
    assert dataclasses.asdict(ovl) == dataclasses.asdict(ref.report(compute_s=c))
    assert dataclasses.asdict(seq) == dataclasses.asdict(ref.report(compute_s=c, overlap=False))
    assert ovl.raw_bw >= seq.raw_bw and ovl.effective_bw >= seq.effective_bw
    assert not _port(name, "sweep").report().overlap


def test_dataflow_overlapping_lanes():
    """While tile j is in flight, j+1's prefetch and j-1's commit land
    inside its compute span on their own lanes; the trace reconciles."""
    compiled = _port("jacobi2d5p", trace=True)
    got = compiled(_inputs("jacobi2d5p"), dtype=torch.float64)
    rec = compiled.last_trace()
    assert rec.reconcile(compiled.pipeline)["ok"]
    compute, fetch, commit = (rec.find(n) for n in ("execute_tile", "copy_in", "copy_out"))
    assert len(compute) == len(fetch) == len(commit) == 8
    assert {s.track for s in compute} == {"port0/compute"}
    assert {s.track for s in fetch} == {"port0/fetch"}
    assert {s.track for s in commit} == {"port0/commit"}

    def inside(inner, outer):
        return outer.t0 <= inner.t0 and inner.t0 + inner.dur <= outer.t0 + outer.dur

    # the pipeline drains at wave boundaries: (wave length - 1) overlapped
    # neighbours per wave, 0 + 2 + 2 + 0 = 4 here
    expected = sum(len(w) - 1 for w in compiled.pipeline.wavefronts())
    assert expected == 4
    assert sum(any(inside(f, c) for c in compute) for f in fetch) >= expected
    assert sum(any(inside(w, c) for c in compute) for w in commit) >= expected
    # tracing does not perturb the result
    sweep = _port("jacobi2d5p", "sweep")(_inputs("jacobi2d5p"), dtype=torch.float64)
    for k in sweep:
        assert torch.equal(got[k], sweep[k])


@pytest.mark.cuda
def test_cuda_dataflow_launches_per_tile():
    """On a card the kernel path launches the tile executor once per tile,
    on the compute stream, and lands the sweep's facets bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    name, space, tile = CASE["jacobi2d5p"]
    compiled = cfa.compile(name, space, layout=tile, overlap=True)
    before = execute_tiles.launches
    got = compiled(_inputs(name), dtype=torch.float64, use_kernel=True)
    torch.cuda.synchronize()
    assert execute_tiles.launches == before + 8
    sweep = compiled.lower("sweep")(_inputs(name), dtype=torch.float64)
    for k in sweep:
        assert torch.equal(got[k], sweep[k])
