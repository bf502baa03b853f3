"""The port's tile pipeline (repro_torch.core.cfa.transform) against the
reference package's, bit for bit.

* ``copy_in``: the halo buffer of every tile, gathered from the same facet
  state, equals the reference's;
* ``_sweep`` and ``_sweep_wavefront`` (host path and the kernel path, which
  on CPU tensors runs the tile kernel's plain version): the facet payload
  equals the reference ``_sweep``'s, in float32 and float64, on all 7
  programs;
* the static addressing (facet shapes, wavefronts, widths) is the same.

Inputs are made with numpy from a seed; facet state moves across as numpy
(``repro_torch.interop``).
"""
import functools

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax  # noqa: F401  (both frameworks in one process)
import jax.numpy as jnp

from repro.core.cfa import CFAPipeline as JaxPipeline
from repro.core.cfa import IterSpace as JaxSpace
from repro.core.cfa import Tiling as JaxTiling
from repro.core.cfa import get_program as jax_program
from repro_torch.core.cfa import CFAPipeline, IterSpace, Tiling, get_program
from repro_torch.interop import facets_from_numpy, facets_to_numpy

CASES = [
    ("jacobi2d5p", (8, 8, 8), (4, 4, 4)),
    ("jacobi2d9p", (8, 8, 8), (4, 4, 4)),
    ("jacobi2d9p-gol", (8, 8, 8), (4, 4, 4)),
    ("gaussian", (4, 16, 16), (2, 8, 8)),
    ("smith-waterman-3seq", (9, 8, 8), (3, 4, 4)),
    ("heat1d", (8, 8), (4, 4)),
    ("heat3d", (4, 4, 4, 4), (2, 2, 2, 2)),
]
IDS = [c[0] for c in CASES]
CASE = {c[0]: c for c in CASES}


@pytest.fixture(autouse=True)
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)  # torch's default


def _inputs(name, space, seed=0):
    w0 = get_program(name).widths[0]
    return np.random.default_rng(seed).normal(size=(w0, *space[1:]))


def _pipes(name):
    _, space, tile = CASE[name]
    ref = JaxPipeline(jax_program(name), JaxSpace(space), JaxTiling(tile))
    mine = CFAPipeline(get_program(name), IterSpace(space), Tiling(tile),
                       device="cpu")
    return ref, mine


@functools.lru_cache(maxsize=None)
def _jax_sweep(name, dtype):
    ref, _ = _pipes(name)
    x = _inputs(name, CASE[name][1])
    return _np_facets(ref._sweep(jnp.asarray(x), dtype=getattr(jnp, dtype)))


def _np_facets(facets):
    return {int(k): np.asarray(v) for k, v in facets.items()}


def _assert_facets_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert g.dtype == want[k].dtype, f"facet {k}"
        np.testing.assert_array_equal(g, want[k], err_msg=f"facet {k}")


@pytest.mark.parametrize("name", IDS)
def test_static_addressing_matches(name):
    ref, mine = _pipes(name)
    assert mine.num_tiles == ref.num_tiles
    assert mine.widths == ref.widths
    assert mine.wavefronts() == ref.wavefronts()
    for k in ref.specs:
        assert mine.facet_shape(k) == ref.facet_shape(k)
    for tile in [ref.wavefronts()[-1][0], ref.wavefronts()[1][0]]:
        maps_r, lo_r, w_r = ref._halo_maps(tile)
        maps_m, lo_m, w_m = mine._halo_maps(tile)
        assert maps_r.keys() == maps_m.keys()
        for key in maps_r:
            np.testing.assert_array_equal(maps_m[key], maps_r[key])


@pytest.mark.parametrize("name", IDS)
def test_copy_in_every_tile_bit_exact(name):
    """Halo buffers gathered from the same (swept) facet state."""
    ref, mine = _pipes(name)
    state = _jax_sweep(name, "float64")
    jf = {k: jnp.asarray(v) for k, v in state.items()}
    tf = facets_from_numpy(state, "cpu")
    for wave in ref.wavefronts():
        for tile in wave:
            want = np.asarray(ref.copy_in(jf, tile))
            got = mine.copy_in(tf, tile)
            assert got.dtype == torch.float64
            np.testing.assert_array_equal(got.numpy(), want, err_msg=str(tile))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", IDS)
def test_sweep_bit_exact(name, dtype):
    _, mine = _pipes(name)
    x = _inputs(name, CASE[name][1])
    got = mine._sweep(torch.from_numpy(x), dtype=getattr(torch, dtype))
    _assert_facets_equal(got, _jax_sweep(name, dtype))


@pytest.mark.parametrize("use_kernel", [False, True], ids=["host", "kernel"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", IDS)
def test_sweep_wavefront_bit_exact(name, dtype, use_kernel):
    _, mine = _pipes(name)
    x = _inputs(name, CASE[name][1])
    got = mine._sweep_wavefront(x, dtype=getattr(torch, dtype),
                                use_kernel=use_kernel)
    _assert_facets_equal(got, _jax_sweep(name, dtype))


def test_facets_update_in_place_and_interop_round_trip():
    """copy_out commits into the facet tensors it is given (documented);
    facet dicts cross between numpy and torch unchanged."""
    _, mine = _pipes("jacobi2d5p")
    facets = mine.init_facets(torch.float64)
    before = {k: v for k, v in facets.items()}
    H = torch.ones(tuple(w + t for w, t in zip(mine.widths, mine.tiling.sizes)),
                   dtype=torch.float64)
    out = mine.copy_out(facets, (0, 0, 0), H)
    for k in before:
        assert out[k] is before[k]
        assert float(before[k].sum()) > 0
    back = facets_to_numpy(facets_from_numpy(facets_to_numpy(out), "cpu"))
    _assert_facets_equal(back, facets_to_numpy(out))
