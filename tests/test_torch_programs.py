"""The port's Table I programs (repro_torch.core.cfa.programs) against the
reference package's.

* the port's untiled oracle ``CFAPipeline.reference_volume`` equals the
  reference's bit for bit on all 7 programs, in float32 and float64;
* each program's ``term_table`` — the flat form the CUDA tile kernel
  evaluates — reproduces ``plane_update`` bit for bit when read the way
  the kernel reads it (halo buffer for live-in planes and the low-side
  halo, computed planes elsewhere), so the kernel's program encoding is
  checked on the CPU too.

Inputs are made with numpy from a seed and handed to both sides as numpy.
XLA on the CPU flushes denormals and torch does not unless asked, so the
fixture turns torch's flushing on (measured: ``gaussian`` differs at ~1e-35
without it).
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax  # noqa: F401  (both frameworks in one process)
import jax.numpy as jnp

from repro.core.cfa import CFAPipeline as JaxPipeline
from repro.core.cfa import IterSpace as JaxSpace
from repro.core.cfa import Tiling as JaxTiling
from repro.core.cfa import get_program as jax_program
from repro.core.cfa.programs import PROGRAMS as JAX_PROGRAMS
from repro_torch.core.cfa import CFAPipeline, IterSpace, Tiling, get_program
from repro_torch.core.cfa.programs import (COMBINE_GOL, COMBINE_MAXPLUS,
                                           COMBINE_SUM, PROGRAMS, term_table)

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


@pytest.fixture(autouse=True)
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)  # torch's default


def _inputs(name, space, seed=0):
    w0 = get_program(name).widths[0]
    return np.random.default_rng(seed).normal(size=(w0, *space[1:]))


def test_registry_matches_reference():
    assert sorted(PROGRAMS) == sorted(JAX_PROGRAMS)
    for name in PROGRAMS:
        mine, ref = get_program(name), jax_program(name)
        assert mine.deps.vectors == ref.deps.vectors
        assert mine.widths == ref.widths
        assert mine.default_tile == ref.default_tile
        assert mine.paper_tiles == ref.paper_tiles
        assert mine.skew == ref.skew


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name,space,tile", CASES, ids=IDS)
def test_reference_volume_bit_exact(name, space, tile, dtype):
    x = _inputs(name, space).astype(dtype)
    ref = JaxPipeline(jax_program(name), JaxSpace(space), JaxTiling(tile))
    got = CFAPipeline(get_program(name), IterSpace(space), Tiling(tile),
                      device="cpu").reference_volume(torch.from_numpy(x))
    want = np.asarray(ref.reference_volume(jnp.asarray(x)))
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _eval_term_table(name, H, w, t0):
    """Evaluate a program's TermTable over one halo buffer exactly as the
    CUDA kernel does: planes in order, each term read from the halo buffer
    for live-in planes / the low-side halo and from the computed interior
    otherwise, combined in table order."""
    tt = term_table(name)
    d = H.dim()
    interior = tuple(slice(w[a], None) for a in range(1, d))
    out = H.clone()  # interior planes overwritten as computed
    for s in range(t0):
        acc = centre = None
        for k, (m, off) in enumerate(zip(tt.depth, tt.offsets)):
            plane = out[w[0] + s - m]
            v = plane[tuple(slice(w[a + 1] + o, w[a + 1] + o + plane.shape[a] - w[a + 1])
                            for a, o in enumerate(off))]
            if tt.combine == COMBINE_SUM:
                term = v * tt.values[k]
                acc = term if acc is None else acc + term
            elif tt.combine == COMBINE_MAXPLUS:
                term = v + tt.values[k]
                acc = term if acc is None else torch.maximum(acc, term)
            else:
                assert tt.combine == COMBINE_GOL
                acc = v if acc is None else acc + v
                if k == tt.centre:
                    centre = v
        if tt.combine == COMBINE_GOL:
            acc = 2.0 * centre - acc / acc.new_tensor(9.0)
        out[(w[0] + s, *interior)] = acc
    return out[(slice(w[0], None), *interior)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,space,tile", CASES, ids=IDS)
def test_term_table_reproduces_plane_update(name, space, tile, dtype):
    prog = get_program(name)
    w = prog.widths
    tt = term_table(name)
    assert len(tt.depth) == len(tt.offsets) == len(tt.values) <= 32
    assert all(1 <= m <= w[0] for m in tt.depth)
    assert all(-w[a + 1] <= o <= 0 for off in tt.offsets for a, o in enumerate(off))
    rng = np.random.default_rng(5)
    H = torch.as_tensor(rng.normal(size=tuple(wa + ta for wa, ta in zip(w, tile))),
                        dtype=dtype)
    pipe = CFAPipeline(prog, IterSpace(space), Tiling(tile), device="cpu")
    want = pipe.execute_tile(H.clone())[tuple(slice(wa, None) for wa in w)]
    got = _eval_term_table(name, H, w, tile[0])
    assert torch.equal(got, want)
