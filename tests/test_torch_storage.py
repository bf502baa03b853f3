"""The port's irredundant and compressed facet storage against the
reference package's, bit for bit.

* ``BlockCodec``: the ``header``/``packed`` words (the reference's
  ``uint32``/``uint64`` words are the port's ``int32``/``int64`` words, bit
  for bit) and ``roundtrip``, for every codec in float32 and float64;
* ``dedup_facets`` / ``rehydrate_facets`` on swept payloads, and
  ``pack_all`` / ``unpack_into`` with and without the storage map;
* ``IrredundantPipeline`` / ``CompressedPipeline`` ``_sweep`` and
  ``_sweep_wavefront`` (host and kernel path), and
  ``compile(storage=...)`` on every program at a pinned layout;
* the front door's storage surface: capability gate, auto-selection,
  ``rehydrate``, ``describe``.

Inputs are made with numpy from a seed; facet state crosses as numpy.
"""
import functools

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax  # noqa: F401  (both frameworks in one process)
import jax.numpy as jnp

from repro import cfa as jcfa
from repro.core.cfa import allocation as jalloc
from repro.core.cfa import irredundant as jirr
from repro.core.cfa import IterSpace as JaxSpace
from repro.core.cfa import Tiling as JaxTiling
from repro.core.cfa import build_facet_specs as jax_specs
from repro.core.cfa import get_program as jax_program
from repro.core.cfa.compress import CODECS as JAX_CODECS
from repro_torch import cfa
from repro_torch.core.cfa import (
    CODECS,
    CFAPipeline,
    CompressedPipeline,
    IrredundantPipeline,
    IterSpace,
    Tiling,
    build_facet_specs,
    build_storage_map,
    dedup_facets,
    get_program,
    pack_all,
    pack_facet,
    rehydrate_facets,
    unpack_into,
)
from repro_torch.interop import facets_from_numpy, facets_to_numpy

CASES = [  # tests/test_irredundant.py's CASES
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
DTYPES = ["float32", "float64"]


@pytest.fixture(autouse=True)
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)  # torch's default


def _inputs(name, seed=0):
    _, space, _ = CASE[name]
    w0 = get_program(name).widths[0]
    return np.random.default_rng(seed).normal(size=(w0, *space[1:]))


def _np(facets):
    return {int(k): np.asarray(v) for k, v in facets.items()}


def _assert_facets_equal(got, want):
    got = facets_to_numpy(got) if any(isinstance(v, torch.Tensor) for v in got.values()) else got
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, f"facet {k}"
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"facet {k}")


def _jax_pipe(cls, name, **kw):
    _, space, tile = CASE[name]
    return cls(jax_program(name), JaxSpace(space), JaxTiling(tile), **kw)


def _port_pipe(cls, name, **kw):
    _, space, tile = CASE[name]
    return cls(get_program(name), IterSpace(space), Tiling(tile), device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _jax_sweep(name, storage, dtype, codec=None):
    if storage == "compressed" and codec == "raw":  # the identity codec: no round-trip
        storage, codec = "irredundant", None
    cls = {"irredundant": jirr.IrredundantPipeline,
           "compressed": jirr.CompressedPipeline}[storage]
    kw = {"codec": codec} if storage == "compressed" else {}
    pipe = _jax_pipe(cls, name, **kw)
    return _np(pipe._sweep(jnp.asarray(_inputs(name)), dtype=getattr(jnp, dtype)))


@functools.lru_cache(maxsize=None)
def _redundant_sweep(name, dtype):
    """The port's redundant payload (held bit for bit against the
    reference's ``_sweep`` in ``test_torch_transform.py``)."""
    pipe = _port_pipe(CFAPipeline, name)
    return facets_to_numpy(pipe._sweep(torch.from_numpy(_inputs(name)),
                                       dtype=getattr(torch, dtype)))


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


def _words(a) -> np.ndarray:
    """A word array as raw bytes (uint32/uint64 and int32/int64 alike)."""
    a = np.asarray(a)
    return a.view(np.uint8).reshape(a.shape + (a.dtype.itemsize,))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("codec", sorted(CODECS))
@pytest.mark.parametrize("shape", [(5, 7, 2), (1,), (2,)], ids=str)  # 69 residuals pad
def test_codec_words_and_roundtrip_match_reference(codec, dtype, shape):
    x = np.random.default_rng(0).normal(size=shape).astype(dtype)
    jh, jp = JAX_CODECS[codec].encode(jnp.asarray(x))
    th, tp = CODECS[codec].encode(torch.from_numpy(x))
    assert th.element_size() == tp.element_size() == x.itemsize
    np.testing.assert_array_equal(_words(th.numpy()), _words(jh))
    np.testing.assert_array_equal(_words(tp.numpy()), _words(jp))
    dec = CODECS[codec].decode(th, tp, shape, getattr(torch, dtype))
    rt = CODECS[codec].roundtrip(torch.from_numpy(x))
    want = np.asarray(JAX_CODECS[codec].roundtrip(jnp.asarray(x)))
    assert rt.dtype == getattr(torch, dtype) and tuple(rt.shape) == shape
    np.testing.assert_array_equal(_words(rt.numpy()), _words(want))
    np.testing.assert_array_equal(_words(dec.numpy()), _words(want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_codec_exact_on_data_that_fits_the_ratio(codec, dtype):
    c = CODECS[codec]
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(6, 11)).astype(dtype))
    if not c.bits:
        assert c.exact(x) and c.roundtrip(x) is x  # raw is the identity
        return
    elem_bits = 8 * x.element_size()
    keep = min(c.bits, elem_bits)
    words = x.view({32: torch.int32, 64: torch.int64}[elem_bits])
    low = (1 << (elem_bits - keep)) - 1
    truncated = (words & ~low).view(x.dtype)  # zero the low residual bits
    assert c.exact(truncated) == JAX_CODECS[codec].exact(jnp.asarray(truncated.numpy()))
    assert c.exact(truncated)
    assert c.exact(x) == JAX_CODECS[codec].exact(jnp.asarray(x.numpy()))


def test_codec_registry_and_widths():
    assert cfa.get_codec(None).name == "deltapack16"
    assert cfa.get_codec("raw").bits == 0
    with pytest.raises(ValueError, match="unknown codec"):
        cfa.get_codec("zstd")
    assert CODECS["deltapack16"]._widths(torch.float64) == (64, 16)
    assert CODECS["deltapack16"]._widths(torch.float32) == (32, 16)
    with pytest.raises(ValueError, match="unsupported element width"):
        CODECS["deltapack8"].encode(torch.zeros(4, dtype=torch.complex128))


# ---------------------------------------------------------------------------
# dedup / rehydrate / pack / unpack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", IDS)
def test_dedup_and_rehydrate_match_reference(name):
    _, space, tile = CASE[name]
    red = _redundant_sweep(name, "float64")
    jsmap = jirr.build_storage_map(jax_specs(JaxSpace(space), jax_program(name).deps,
                                             JaxTiling(tile)))
    smap = _port_pipe(IrredundantPipeline, name).storage_map
    jdd = _np(jirr.dedup_facets({k: jnp.asarray(v) for k, v in red.items()}, jsmap))
    dd = dedup_facets(facets_from_numpy(red, "cpu"), smap)
    _assert_facets_equal(dd, jdd)
    jrh = _np(jirr.rehydrate_facets({k: jnp.asarray(v) for k, v in jdd.items()}, jsmap))
    rh = rehydrate_facets(dd, smap)
    _assert_facets_equal(rh, jrh)
    _assert_facets_equal(rh, red)  # rehydration restores the redundant payload
    for k in smap.owned:
        if smap.owned[k].all():  # fully owned facets pass through
            assert rh[k] is dd[k]


@pytest.mark.parametrize("dedup", [False, True], ids=["redundant", "irredundant"])
def test_pack_all_and_unpack_into_match_reference(dedup):
    name, space, tile = "jacobi2d5p", (8, 8, 8), (2, 4, 4)  # w | t on every axis
    specs = build_facet_specs(IterSpace(space), get_program(name).deps, Tiling(tile))
    jspecs = jax_specs(JaxSpace(space), jax_program(name).deps, JaxTiling(tile))
    smap = build_storage_map(specs) if dedup else None
    jsmap = jirr.build_storage_map(jspecs) if dedup else None
    V = np.random.default_rng(0).normal(size=space)
    got = pack_all(torch.from_numpy(V), specs, storage_map=smap)
    want = _np(jalloc.pack_all(jnp.asarray(V), jspecs, storage_map=jsmap))
    _assert_facets_equal(got, want)
    for k in specs:
        assert torch.equal(pack_facet(torch.from_numpy(V), specs[k]),
                           facets_from_numpy(_np(jalloc.pack_all(jnp.asarray(V), jspecs)),
                                             "cpu")[k])
    out = torch.full(space, float("nan"), dtype=torch.float64)
    jout = jnp.full(space, jnp.nan)
    for k in specs:
        owned = smap.owned[k] if dedup else None
        out = unpack_into(out, got[k], specs[k], owned=owned)
        jout = jalloc.unpack_into(jout, jnp.asarray(want[k]), jspecs[k], owned=owned)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    mask = ~np.isnan(out.numpy())
    np.testing.assert_array_equal(out.numpy()[mask], V[mask])


def test_unpack_into_leaves_its_volume_unchanged():
    specs = build_facet_specs(IterSpace((8, 8, 8)), get_program("jacobi2d5p").deps,
                              Tiling((2, 4, 4)))
    vol = torch.zeros((8, 8, 8), dtype=torch.float64)
    out = unpack_into(vol, torch.ones(specs[1].shape, dtype=torch.float64), specs[1])
    assert float(vol.abs().sum()) == 0.0 and float(out.sum()) > 0


def test_pack_unpack_w_divides_t_error_paths():
    specs = build_facet_specs(IterSpace((9, 9, 9)), get_program("jacobi2d5p").deps,
                              Tiling((3, 3, 3)))  # w = 2 does not divide t = 3
    V = torch.zeros((9, 9, 9))
    with pytest.raises(ValueError, match="sweep executor"):
        pack_facet(V, specs[1])
    with pytest.raises(ValueError, match="sweep executor"):
        pack_all(V, specs)
    with pytest.raises(ValueError, match="sweep executor"):
        unpack_into(V, torch.zeros(specs[2].shape), specs[2])


# ---------------------------------------------------------------------------
# the pipelines
# ---------------------------------------------------------------------------


def _sweep_params():
    out = []
    for name in IDS:
        for storage in ("irredundant", "compressed"):
            for method in ("sweep", "wavefront", "kernel"):
                if method == "kernel" and (name not in THREE_D or storage == "compressed"):
                    continue
                out.append(pytest.param(name, storage, method,
                                        id=f"{name}-{storage}-{method}"))
    return out


@pytest.mark.parametrize("name,storage,method", _sweep_params())
def test_storage_sweeps_bit_exact(name, storage, method):
    """Port pipelines against the reference's ``_sweep`` of the same
    discipline (compressed: the default ``deltapack16`` codec in float32 —
    lossy, and identical in both packages; the ``raw`` codec is pinned to
    the irredundant payload below)."""
    cls = {"irredundant": IrredundantPipeline, "compressed": CompressedPipeline}[storage]
    runs = [("float64", None)] if storage == "irredundant" else [("float32", "deltapack16")]
    for dtype, codec in runs:
        kw = {"codec": codec} if codec else {}
        pipe = _port_pipe(cls, name, **kw)
        x = torch.from_numpy(_inputs(name))
        if method == "sweep":
            got = pipe._sweep(x, dtype=getattr(torch, dtype))
        else:
            got = pipe._sweep_wavefront(x, dtype=getattr(torch, dtype),
                                        use_kernel=method == "kernel")
        _assert_facets_equal(got, _jax_sweep(name, storage, dtype, codec))


@pytest.mark.parametrize("storage", ["irredundant", "compressed"])
@pytest.mark.parametrize("name", IDS)
def test_compile_storage_matches_reference(name, storage):
    _, space, tile = CASE[name]
    c = cfa.compile(name, space, layout=tile, storage=storage, device="cpu")
    ref = jcfa.compile(name, space, layout=tile, storage=storage)
    assert c.storage == c.pipeline.storage == storage
    want_backend = "cuda" if (len(space) == 3 and storage == "irredundant") else "wavefront"
    assert c.backend == want_backend
    assert (ref.backend == "pallas") == (want_backend == "cuda")
    assert c.plan.footprint == ref.plan.footprint
    assert c.storage_map.stored_elems == ref.storage_map.stored_elems
    # compressed: the default deltapack16 codec, lossy in float32
    dtype, codec = ("float32", "deltapack16") if storage == "compressed" else ("float64", None)
    got = c(_inputs(name), dtype=getattr(torch, dtype))
    payload = _jax_sweep(name, storage, dtype, codec)
    _assert_facets_equal(got, payload)
    rh = c.rehydrate(got)
    want = ref.rehydrate({k: jnp.asarray(v) for k, v in payload.items()})
    _assert_facets_equal(rh, _np(want))
    if storage == "irredundant":  # rehydration bridges to the redundant payload
        _assert_facets_equal(rh, _redundant_sweep(name, "float64"))


def test_compressed_raw_codec_equals_irredundant():
    name, space, tile = CASE["jacobi2d5p"]
    irr = cfa.compile(name, space, layout=tile, backend="sweep", storage="irredundant",
                      device="cpu")(_inputs(name), dtype=torch.float64)
    raw = cfa.compile(name, space, layout=tile, backend="sweep", storage="compressed",
                      codec="raw", device="cpu")
    assert raw.codec.name == "raw"
    _assert_facets_equal(raw(_inputs(name), dtype=torch.float64), facets_to_numpy(irr))


def test_masked_commit_writes_owned_slots_only():
    """The in-place commit leaves every dead slot of the facet tensor as it
    was (the reference's ``where(mask, block, arr[idx])``)."""
    pipe = _port_pipe(IrredundantPipeline, "jacobi2d5p")
    facets = {k: torch.full(pipe.facet_shape(k), 7.0, dtype=torch.float64)
              for k in pipe.specs}
    H = torch.ones(tuple(w + t for w, t in zip(pipe.widths, pipe.tiling.sizes)),
                   dtype=torch.float64)
    out = pipe.copy_out(facets, (1, 1, 1), H)
    for k, spec in pipe.specs.items():
        assert out[k] is facets[k]
        idx = pipe._block_index(spec, (1, 1, 1), False)
        blk = out[k][idx]
        owned = torch.from_numpy(pipe.storage_map.owned[k])
        assert bool((blk[owned] == 1.0).all()) and bool((blk[~owned] == 7.0).all())


# ---------------------------------------------------------------------------
# the front door's storage surface
# ---------------------------------------------------------------------------


def test_compressed_is_rejected_by_the_cuda_backend():
    with pytest.raises(cfa.BackendError, match="compressed"):
        cfa.compile("jacobi2d5p", (8, 8, 8), layout=(4, 4, 4), backend="cuda",
                    storage="compressed", device="cpu")
    j = cfa.get_program("jacobi2d5p")
    assert cfa.select_backend(j, cfa.IterSpace((8, 8, 8)), storage="compressed") == "wavefront"
    assert cfa.select_backend(j, cfa.IterSpace((8, 8, 8)), storage="irredundant") == "cuda"
    have = cfa.available_backends(j, cfa.IterSpace((8, 8, 8)), storage="compressed")
    assert "cuda" not in have and {"reference", "sweep", "wavefront"} <= set(have)
    c = cfa.compile("jacobi2d5p", (8, 8, 8), layout=(4, 4, 4), storage="compressed",
                    device="cpu")
    assert c.lower("sweep").backend == "sweep"
    with pytest.raises(cfa.BackendError, match="compressed"):
        c.lower("cuda")


def test_storage_argument_validation():
    with pytest.raises(ValueError, match="storage"):
        cfa.compile("jacobi2d5p", (8, 8, 8), layout=(4, 4, 4), storage="dedup",
                    device="cpu")
    with pytest.raises(ValueError, match="compressed"):
        cfa.compile("jacobi2d5p", (8, 8, 8), layout=(4, 4, 4), codec="deltapack16",
                    device="cpu")


def test_describe_report_and_rehydrate_identity():
    c = cfa.compile("jacobi2d5p", (8, 8, 8), layout=(4, 4, 4), backend="sweep",
                    storage="irredundant", device="cpu")
    ref = jcfa.compile("jacobi2d5p", (8, 8, 8), layout=(4, 4, 4), backend="sweep",
                       storage="irredundant")
    assert "irredundant storage (footprint" in c.describe()
    assert c.report().storage == "irredundant"
    assert c.report().footprint == ref.report().footprint == c.plan.footprint
    red = cfa.compile("jacobi2d5p", (8, 8, 8), layout=(4, 4, 4), device="cpu")
    assert red.storage_map is None and red.rehydrate(d := {0: torch.zeros(1)}) is d
    assert "storage" not in red.describe()
