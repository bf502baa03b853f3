"""The port's CFA read engine (repro_torch.kernels.facet_fetch) on CPU
tensors, where the wrapper runs the kernel's plain PyTorch version.

The CUDA kernel itself is held against this plain version on the card by
``chip_smoke.py`` (difference 0, both storages, float32 and float64).
Here, on facets the port sweeps from seeded numpy inputs (its sweeps are
held bit for bit against the reference's in ``test_torch_storage.py`` and
``test_torch_transform.py``), handed to both packages as numpy:

* the plain path against the reference's Pallas kernel
  (``interpret=True``) and its ``fetch_interior_halos_ref`` under redundant
  storage, and against the reference's irredundant kernel and its
  owner-resolved ``IrredundantPipeline.copy_in`` under irredundant storage
  (tolerance 0: the function moves data and computes nothing);
* the kernel's burst plan (per tile the (facet, start, length) bursts of
  ``burst_plan``, the merged pairs adjacent in the facet array, their union
  covering every element the plain version reads) and its assembly from
  the staged bursts by the owner rule, transliterated to numpy from
  ``csrc/facet_fetch.cu``, against the plain version bit for bit;
* the slice end to end on the CPU: autotune -> ``best_cfa(kernel_compatible
  =True)`` -> ``compile(storage="irredundant")`` -> run -> fetch;
* the rejections (messages of the reference), the launch counter and the
  C entry point's arity.
"""
import ast
import functools
import re
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax  # noqa: F401  (both frameworks in one process)
import jax.numpy as jnp

from repro.core.cfa import IterSpace as JaxSpace
from repro.core.cfa import Tiling as JaxTiling
from repro.core.cfa import get_program as jax_program
from repro.core.cfa.irredundant import IrredundantPipeline as JaxIrredundant
from repro.kernels.facet_fetch import fetch_interior_halos as jax_fetch
from repro.kernels.facet_fetch import fetch_interior_halos_ref as jax_fetch_ref
from repro_torch import cfa
from repro_torch.core.cfa import (
    CFAPipeline,
    IrredundantPipeline,
    IterSpace,
    Tiling,
    dedup_facets,
    get_program,
    rehydrate_facets,
)
from repro_torch.interop import facets_from_numpy, facets_to_numpy
from repro_torch.kernels.facet_fetch import fetch_interior_halos, fetch_interior_halos_ref
from repro_torch.kernels.facet_fetch import facet_fetch as fetch_mod

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"

FETCH_CASES = [  # tests/test_kernels.py's facet-fetch cases
    ("jacobi2d5p", (8, 8, 8), (4, 4, 4)),
    ("jacobi2d9p", (12, 8, 8), (4, 4, 4)),
    ("gaussian", (4, 16, 16), (2, 8, 8)),
]
IDS = [c[0] for c in FETCH_CASES]
DTYPES = ["float32", "float64"]


@pytest.fixture(autouse=True)
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)  # torch's default


def _inputs(name, space, seed=0):
    w0 = get_program(name).widths[0]
    return np.random.default_rng(seed).normal(size=(w0, *space[1:]))


@functools.lru_cache(maxsize=None)
def _payload(name, space, tile, storage, dtype):
    """The swept facets under ``storage``, as numpy."""
    cls = IrredundantPipeline if storage == "irredundant" else CFAPipeline
    pipe = cls(get_program(name), IterSpace(space), Tiling(tile), device="cpu")
    out = pipe._sweep(torch.from_numpy(_inputs(name, space)), dtype=getattr(torch, dtype))
    return facets_to_numpy(out)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def _assert_bit_equal(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


# ---------------------------------------------------------------------------
# the plain path against the reference package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,space,tile", FETCH_CASES, ids=IDS)
def test_redundant_fetch_matches_reference_kernel(name, space, tile, dtype):
    facets = _payload(name, space, tile, "redundant", dtype)
    got = fetch_interior_halos(name, facets_from_numpy(facets, "cpu"), space, tile)
    jf = {k: jnp.asarray(v) for k, v in facets.items()}
    _assert_bit_equal(got, jax_fetch(name, jf, space, tile, interpret=True))
    _assert_bit_equal(got, jax_fetch_ref(name, jf, space, tile))
    assert torch.equal(got, fetch_interior_halos_ref(
        name, facets_from_numpy(facets, "cpu"), space, tile))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,space,tile", FETCH_CASES, ids=IDS)
def test_irredundant_fetch_matches_reference_kernel(name, space, tile, dtype):
    """Over the irredundant payload: the reference's irredundant kernel,
    its owner-resolved copy_in on every interior tile, and the redundant
    fetch over the rehydrated payload all agree bit for bit."""
    payload = _payload(name, space, tile, "irredundant", dtype)
    dd = facets_from_numpy(payload, "cpu")
    got = fetch_interior_halos(name, dd, space, tile, storage="irredundant")
    jf = {k: jnp.asarray(v) for k, v in payload.items()}
    _assert_bit_equal(got, jax_fetch(name, jf, space, tile, interpret=True,
                                     storage="irredundant"))
    jpipe = JaxIrredundant(jax_program(name), JaxSpace(space), JaxTiling(tile))
    for q in np.ndindex(*(n - 1 for n in jpipe.num_tiles)):
        want = jpipe.copy_in(jf, tuple(int(i) + 1 for i in q))
        _assert_bit_equal(got[q], want)
    smap = IrredundantPipeline(get_program(name), IterSpace(space), Tiling(tile),
                               device="cpu").storage_map
    red = fetch_interior_halos(name, rehydrate_facets(dd, smap), space, tile)
    assert torch.equal(got.view(torch.uint8), red.view(torch.uint8))
    full = _payload(name, space, tile, "redundant", dtype)
    assert torch.equal(red, fetch_interior_halos(name, facets_from_numpy(full, "cpu"),
                                                 space, tile))


def test_owner_indirection_is_load_bearing():
    """The redundant fetch over a deduplicated payload reads dead zeros;
    the irredundant one does not."""
    name, space, tile = FETCH_CASES[0]
    pipe = CFAPipeline(get_program(name), IterSpace(space), Tiling(tile), device="cpu")
    facets = pipe._sweep(torch.from_numpy(_inputs(name, space)), torch.float32)
    smap = IrredundantPipeline(get_program(name), IterSpace(space), Tiling(tile),
                               device="cpu").storage_map
    dd = dedup_facets(facets, smap)
    h_red = fetch_interior_halos(name, facets, space, tile)
    assert torch.equal(fetch_interior_halos(name, dd, space, tile, storage="irredundant"),
                       h_red)
    assert not torch.equal(fetch_interior_halos(name, dd, space, tile), h_red)


@pytest.mark.parametrize("storage", ["redundant", "irredundant"])
def test_t_equal_w_axis(storage):
    """The full-size path's tile has t2 == w2 == 2: every ``t - w`` slice
    is empty and facet_2 stores whole tiles."""
    name, space, tile = "jacobi2d5p", (16, 8, 4), (8, 4, 2)
    facets = _payload(name, space, tile, storage, "float32")
    got = fetch_interior_halos(name, facets_from_numpy(facets, "cpu"), space, tile,
                               storage=storage)
    jf = {k: jnp.asarray(v) for k, v in facets.items()}
    _assert_bit_equal(got, jax_fetch(name, jf, space, tile, interpret=True,
                                     storage=storage))
    assert tuple(got.shape) == (1, 1, 1, 9, 6, 4)


# ---------------------------------------------------------------------------
# the kernel's per-element rule, transliterated
# ---------------------------------------------------------------------------


#: the kernel's slots: (facet, tile offset of the first block, pair axis or None)
SLOTS = [(0, (-1, -1, 0), 1), (0, (-1, -1, -1), 1), (1, (0, -1, -1), 2), (2, (0, 0, -1), None),
         (0, (0, -1, 0), None), (0, (0, -1, -1), 1), (1, (0, 0, -1), None)]


def _block_start(facets, k, tile) -> int:
    """Flat element index of facet ``k``'s block of ``tile``, from the array's
    own shape and the layout's outer order (facet_0 past its virtual row)."""
    a, b, c = tile
    outer = {0: (a + 1, c, b), 1: (b, a, c), 2: (c, b, a)}[k]
    return int(np.ravel_multi_index((*outer, 0, 0, 0), tuple(facets[k].shape)))


def _tiles(geo):
    return [tuple(int(i) + 1 for i in q) for q in np.ndindex(*geo.g)]


def _bursts(facets, geo, storage, q):
    """The kernel's bursts of tile ``q``: (facet, slot base, start, len) in
    flat elements of the facet array, from ``burst_plan``'s ``c + q . s``."""
    slots, _ = fetch_mod.burst_plan(geo, facets, storage, facets[0].element_size())
    return [(k, c + int(np.dot(q, (s0, s1, s2))), start, n)
            for k, c, s0, s1, s2, _, start, n in slots.tolist()]


def _kernel_rule(facets, geo, storage):
    """``facet_fetch_kernel`` of ``csrc/facet_fetch.cu`` per tile: stage each
    burst into its slot (the rest of a slot is NaN, never to be read), then
    assemble every output element from the slots by the owner rule."""
    w, t = np.array(geo.w), np.array(geo.t)
    (w0, w1, w2), (t0, t1, t2) = w, t
    B0, B1 = t1 * t2 * w0, t2 * t0 * w1
    h = w + t
    x = np.indices(tuple(h)).reshape(3, -1)
    halo = x < w[:, None]
    irr = storage == "irredundant"
    own = halo | ((x >= t[:, None]) & irr)
    flat = [f.reshape(-1).numpy() for f in (facets[0], facets[1], facets[2])]
    out = np.zeros((*geo.g, *h), dtype=flat[0].dtype)
    for q in _tiles(geo):
        staged = []
        for k, base, start, n in _bursts(facets, geo, storage, q):
            slot = np.full(start + n, np.nan, flat[0].dtype)
            slot[start:] = flat[k][base + start:base + start + n]
            staged.append(slot)
        vals = np.zeros(x.shape[1], flat[0].dtype)
        i2 = x[2] - w2 + np.where(halo[2], t2, 0)
        i1 = x[1] - w1 + np.where(halo[1], t1, 0)
        sel0 = halo.any(0) & own[0]
        sel1 = halo.any(0) & ~own[0] & own[1]
        sel2 = halo.any(0) & ~own[0] & ~own[1]
        for e in np.flatnonzero(sel0):
            sp = staged[(1 if halo[2, e] else 0) if halo[0, e] else (5 if halo[2, e] else 4)]
            vals[e] = sp[(0 if halo[1, e] else B0) + (i1[e] * t2 + i2[e]) * w0 + x[0, e] % w0]
        for e in np.flatnonzero(sel1):
            sp = staged[2 if halo[1, e] else 6]
            vals[e] = sp[(0 if halo[2, e] else B1) + (i2[e] * t0 + x[0, e] - w0) * w1
                         + x[1, e] % w1]
        for e in np.flatnonzero(sel2):
            vals[e] = staged[3][((x[0, e] - w0) * t1 + x[1, e] - w1) * w2 + x[2, e]]
        out[tuple(a - 1 for a in q)] = vals.reshape(tuple(h))
    return out


RULE_CASES = FETCH_CASES + [("jacobi2d5p", (16, 8, 8), (8, 4, 2)),
                            ("smith-waterman-3seq", (9, 8, 8), (3, 4, 4))]
RULE_IDS = IDS + ["t2=w2", "w0=3"]


def _random_facets(name, space, tile, seed=3):
    rng = np.random.default_rng(seed)
    pipe = CFAPipeline(get_program(name), IterSpace(space), Tiling(tile), device="cpu")
    return {k: torch.from_numpy(rng.normal(size=pipe.facet_shape(k)))
            for k in pipe.specs}  # any values: every slot is addressable


@pytest.mark.parametrize("storage", ["redundant", "irredundant"])
@pytest.mark.parametrize("name,space,tile", RULE_CASES, ids=RULE_IDS)
def test_kernel_rule_equals_plain_version(name, space, tile, storage):
    facets = _random_facets(name, space, tile)
    geo = fetch_mod.fetch_geometry(name, facets, space, tile, storage)
    want = fetch_interior_halos_ref(name, facets, space, tile, storage=storage)
    _assert_bit_equal(torch.from_numpy(_kernel_rule(facets, geo, storage)), want.numpy())


@pytest.mark.parametrize("storage", ["redundant", "irredundant"])
@pytest.mark.parametrize("name,space,tile", RULE_CASES, ids=RULE_IDS)
def test_bursts_are_merged_blocks_that_cover_the_plain_reads(name, space, tile, storage):
    """Per tile: 4 (redundant) or 7 (irredundant) bursts; a slot's first
    block is the facet's block of tile q + d, a merged pair's second block
    follows it in the facet array, and every facet element the plain
    version reads for the tile lies inside a burst of the tile."""
    facets = _random_facets(name, space, tile)
    geo = fetch_mod.fetch_geometry(name, facets, space, tile, storage)
    ids, base = {}, 1
    for k in range(3):
        n = facets[k].numel()
        ids[k] = torch.arange(base, base + n).reshape(facets[k].shape)
        base += n
    read = fetch_interior_halos_ref(name, ids, space, tile, storage=storage)
    offsets = np.cumsum([1] + [facets[k].numel() for k in range(3)])
    for q in _tiles(geo):
        bursts = _bursts(facets, geo, storage, q)
        assert len(bursts) == (7 if storage == "irredundant" else 4)
        for (k, slot_base, start, n), (k2, d, pair) in zip(bursts, SLOTS):
            first = tuple(a + b for a, b in zip(q, d))
            assert k == k2 and slot_base == _block_start(facets, k, first)
            block = facets[k][0, 0, 0].numel()
            if start + n > block:  # a merged pair: the next block along its axis
                nxt = tuple(a + (i == pair) for i, a in enumerate(first))
                assert slot_base + block == _block_start(facets, k, nxt)
                assert start + n == 2 * block
        need = np.unique(read[tuple(a - 1 for a in q)].numpy())
        need = need[need > 0]
        covered = np.zeros(need.shape, bool)
        for k, slot_base, start, n in bursts:
            lo = offsets[k] + slot_base + start
            covered |= (need >= lo) & (need < lo + n)
        assert covered.all(), f"tile {q}: {int((~covered).sum())} elements read outside the bursts"


def test_burst_plan_at_the_cut_cell():
    """The cut irredundant cell's tile (16, 256, 2), w (1, 2, 2): 7 bursts,
    ~39 KiB staged per CTA in float32 (five CTAs per SM), bulk copies for
    every burst of 16-byte aligned facets."""
    name, space, tile = "jacobi2d5p", (64, 1024, 1024), (16, 256, 2)
    pipe = CFAPipeline(get_program(name), IterSpace(space), Tiling(tile), device="cpu")
    facets = {k: torch.empty(pipe.facet_shape(k), device="meta") for k in pipe.specs}
    geo = fetch_mod.fetch_geometry(name, facets, space, tile, "irredundant")
    slots, smem = fetch_mod.burst_plan(geo, facets, "irredundant", 4)
    assert slots[:, 7].tolist() == [516, 516, 128, 8192, 4, 516, 64]
    assert smem == sum(-(-n * 4 // 16) * 16 for n in slots[:, 7].tolist()) == 39744
    assert 5 * (smem + 1024) <= 233472
    assert all(n * 4 % 16 == 0 for n in slots[:, 7].tolist())
    assert fetch_mod.burst_plan(geo, facets, "redundant", 8)[1] == 74816


def test_burst_paths_word_loads_and_reads_in_place():
    """Bursts whose start or size is not a multiple of 16 bytes take word
    loads (w0 = 3 makes facet_1's tails 36 bytes); a tile whose bursts exceed
    shared memory stages nothing and reads them in place."""
    name, space, tile = "smith-waterman-3seq", (9, 8, 8), (3, 4, 4)
    facets = _random_facets(name, space, tile)
    geo = fetch_mod.fetch_geometry(name, facets, space, tile, "irredundant")
    paths = fetch_mod.burst_paths(geo, {k: v.float() for k, v in facets.items()}, "irredundant")
    assert paths["word"] > 0 and paths["bulk"] > 0 and paths["staged_bytes"] > 0
    name, space, tile = "jacobi2d5p", (128, 1024, 16), (64, 512, 8)
    pipe = CFAPipeline(get_program(name), IterSpace(space), Tiling(tile), device="cpu")
    facets = {k: torch.empty(pipe.facet_shape(k), device="meta") for k in pipe.specs}
    geo = fetch_mod.fetch_geometry(name, facets, space, tile, "redundant")
    slots, smem = fetch_mod.burst_plan(geo, facets, "redundant", 4)
    assert smem == 0 and slots[3, 7] * 4 > fetch_mod.MAX_STAGED


def test_strides_come_from_the_facet_specs():
    name, space, tile = "jacobi2d9p", (12, 8, 8), (4, 4, 4)
    pipe = CFAPipeline(get_program(name), IterSpace(space), Tiling(tile), device="cpu")
    facets = pipe.init_facets(torch.float32)
    geo = fetch_mod.fetch_geometry(name, facets, space, tile, "redundant")
    base, outer = fetch_mod._strides(geo.specs, facets)
    assert base.dtype == outer.dtype == np.int64 and outer.shape == (3, 3)
    # facet_0 (nt0+1, nt2, nt1, t1, t2, w0): the virtual row is one q0 stride
    assert base.tolist() == [outer[0, 0], 0, 0]
    w0 = get_program(name).widths[0]
    assert outer[0].tolist() == [2 * 2 * 4 * 4 * w0, 4 * 4 * w0, 2 * 4 * 4 * w0]


# ---------------------------------------------------------------------------
# the slice end to end on the CPU
# ---------------------------------------------------------------------------


def test_autotuned_irredundant_path_fetches_the_redundant_halos(tmp_path):
    """autotune -> best kernel-compatible CFA layout -> irredundant compile
    (auto backend ``cuda``) -> run -> fetch: the irredundant fetch over the
    payload equals the redundant fetch over the rehydrated payload and the
    reference's fetch over the reference's redundant sweep at that layout."""
    name, space = "jacobi2d5p", (16, 16, 16)
    decision = cfa.autotune(name, space, storage="irredundant", budget=24, seed=0,
                            cache_dir=tmp_path)
    cand = decision.best_cfa(kernel_compatible=True).candidate
    assert cand.is_default_cfa_layout(3)
    compiled = cfa.compile(name, space, storage="irredundant", layout=cand, device="cpu")
    assert compiled.backend == "cuda"
    x = np.random.default_rng(1).normal(size=(1, *space[1:]))
    payload = compiled(x)
    got = fetch_interior_halos(name, payload, space, cand.tile, storage="irredundant")
    red = fetch_interior_halos(name, compiled.rehydrate(payload), space, cand.tile)
    assert torch.equal(got, red)
    jf = {k: jnp.asarray(v) for k, v in facets_to_numpy(compiled.rehydrate(payload)).items()}
    _assert_bit_equal(got, jax_fetch_ref(name, jf, space, cand.tile))


# ---------------------------------------------------------------------------
# the wrapper: rejections, device handling, counter, C binding
# ---------------------------------------------------------------------------


def _facets(name, space, tile, dtype=torch.float32):
    pipe = CFAPipeline(get_program(name), IterSpace(space), Tiling(tile), device="cpu")
    return pipe.init_facets(dtype)


def _both_raise(exc, match, name, space, tile, storage="redundant", facets=None):
    """The port and the reference reject the same request the same way."""
    f = _facets(name, space, tile) if facets is None else facets
    with pytest.raises(exc, match=match):
        fetch_interior_halos(name, f, space, tile, storage=storage)
    jf = {k: jnp.asarray(v.numpy()) for k, v in f.items()}
    with pytest.raises(exc, match=match):
        jax_fetch(name, jf, space, tile, storage=storage)


def test_rejections_match_the_reference():
    _both_raise(ValueError, "3-D facet layouts only", "heat1d", (8, 8), (4, 4))
    _both_raise(ValueError, "3-D facet layouts only", "heat3d", (4, 4, 4, 4), (2, 2, 2, 2))
    for storage in ("compressed", "dedup"):
        _both_raise(ValueError, "no in-kernel decode stage", "jacobi2d5p", (8, 8, 8),
                    (4, 4, 4), storage=storage)
    _both_raise(ValueError, r"w \| t \(axis 0: t=4, w=3\)", "smith-waterman-3seq",
                (8, 8, 8), (4, 4, 4))
    _both_raise(ValueError, "at least 2 tiles per axis", "jacobi2d5p", (4, 8, 8), (4, 4, 4))


def test_rejects_facets_the_kernel_cannot_address():
    name, space, tile = "jacobi2d5p", (8, 8, 8), (4, 4, 4)
    f = _facets(name, space, tile)
    with pytest.raises(ValueError, match="facet_0 must have shape"):
        fetch_interior_halos(name, {**f, 0: f[0][1:]}, space, tile)  # no virtual row
    with pytest.raises(ValueError, match="facet_2 must have shape"):
        fetch_interior_halos(name, {0: f[0], 1: f[1]}, space, tile)
    with pytest.raises(TypeError, match="one dtype"):
        fetch_interior_halos(name, {**f, 1: f[1].double()}, space, tile)
    # another extension direction permutes facet_1's block: (t0, t2, w1)
    other = CFAPipeline(get_program(name), IterSpace((8, 8, 16)), Tiling((4, 4, 8)),
                        ext_dirs=((0, 1), (1, 0), (2, 0)), device="cpu")
    with pytest.raises(ValueError, match=r"facet_1 must have shape \(2, 2, 2, 8, 4, 2\)"):
        fetch_interior_halos(name, other.init_facets(), (8, 8, 16), (4, 4, 8))
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        fetch_interior_halos(name, {k: v.to("meta") for k, v in f.items()}, space, tile)


def test_plain_version_is_the_wrapper_on_cpu_and_does_not_count():
    name, space, tile = FETCH_CASES[2]
    rng = np.random.default_rng(5)
    pipe = CFAPipeline(get_program(name), IterSpace(space), Tiling(tile), device="cpu")
    facets = {k: torch.from_numpy(rng.normal(size=pipe.facet_shape(k))).float()
              for k in pipe.specs}
    before = {k: v.clone() for k, v in facets.items()}
    fetch_interior_halos.launches = 0
    for storage in ("redundant", "irredundant"):
        got = fetch_interior_halos(name, facets, space, tile, storage=storage)
        assert torch.equal(got, fetch_interior_halos_ref(name, facets, space, tile,
                                                         storage=storage))
    assert fetch_interior_halos.launches == 0
    assert all(torch.equal(facets[k], before[k]) for k in facets)  # read only


def test_cuda_facets_launch_the_kernel_never_the_plain_version(monkeypatch):
    """On a card the wrapper launches the kernel (and counts it); the plain
    version is never its way out."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    name, space, tile = FETCH_CASES[0]
    facets = {k: v.cuda().normal_() for k, v in _facets(name, space, tile).items()}
    want = fetch_interior_halos_ref(name, facets, space, tile)

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(fetch_mod, "_assemble_interior", plain)
    before = fetch_interior_halos.launches
    got = fetch_interior_halos(name, facets, space, tile)
    torch.cuda.synchronize()
    assert fetch_interior_halos.launches == before + 1
    assert torch.equal(got, want)


def test_c_entry_point_matches_the_ctypes_binding():
    """The wrapper's argtypes and the .cu entry point agree in arity (the
    geometry and the burst plan travel as two arrays)."""
    src = (SRC / "facet_fetch" / "csrc" / "facet_fetch.cu").read_text()
    sig = re.search(r'extern "C" int facet_fetch\((.*?)\)\s*\{', src, re.S).group(1)
    n_params = len([p for p in sig.split(",") if p.strip()])
    tree = ast.parse((SRC / "facet_fetch" / "facet_fetch.py").read_text())
    argtypes = next(node.value for node in ast.walk(tree)
                    if isinstance(node, ast.Assign)
                    and any(getattr(t, "attr", None) == "argtypes" for t in node.targets))
    assert len(argtypes.elts) == n_params == 8
