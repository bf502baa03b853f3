"""The port's stencil tile executor wrapper (repro_torch.kernels.stencil)
on CPU tensors, where it runs the kernel's plain PyTorch version.

The CUDA kernel itself is held against this plain version on the card by
``chip_smoke.py`` (bit-exact, every program, both dtypes); here the plain
path is held against the reference package's Pallas kernel
(``interpret=True``) and its jnp oracle, with the parametrisation and
tolerance of ``tests/test_kernels.py``, and the wrapper's checks, launch
counter and build plumbing are pinned without a card.

The kernel's cluster schedule is transliterated to numpy: each tile cut by
``launch_plan`` into strips, each strip a ring of w0+1+ahead plane slots
that start as NaN, filled from the halo buffer (live-in planes whole, then
each plane's own low-side halo ``ahead`` planes early) and by the lower
neighbour's last w_s rows after each plane, the terms read from the ring in
table order.  A read of a slot element the schedule never filled shows as
NaN.  It is held bit-equal to the plain version (what the kernel is held to
on the card) for every program in float32 and float64, at the planned and at
forced splits, and to the reference's Pallas kernel within the tolerance
above (XLA re-associates, so that side is not bitwise).  ``launch_plan`` is
pinned at the three path shapes, and the per-port wrapper (1s) checks its
arguments once per call.
"""
import ast
import re
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax  # noqa: F401  (both frameworks in one process)
import jax.numpy as jnp

from repro.kernels.stencil import execute_tiles as jax_execute_tiles
from repro.kernels.stencil import execute_tiles_ref as jax_execute_tiles_ref
from repro_torch.core.cfa import get_program
from repro_torch.core.cfa.programs import COMBINE_GOL, COMBINE_MAXPLUS, COMBINE_SUM, PROGRAMS
from repro_torch.distributed.sharding import port_mesh
from repro_torch.kernels import _build
from repro_torch.kernels.stencil import execute_tiles, execute_tiles_ref, execute_tiles_sharded
from repro_torch.kernels.stencil import launch_plan
from repro_torch.kernels.stencil import stencil as stencil_mod

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"


@pytest.fixture(autouse=True)
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)  # torch's default


def _halos(name, tile, batch, seed, dtype):
    w = get_program(name).widths
    shape = (batch, *(wa + ta for wa, ta in zip(w, tile)))
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


@pytest.mark.parametrize("name", ["jacobi2d5p", "jacobi2d9p", "jacobi2d9p-gol",
                                  "gaussian", "smith-waterman-3seq"])
@pytest.mark.parametrize("tile,batch", [((4, 8, 8), 3), ((8, 16, 16), 2)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_stencil_matches_reference_kernel(name, tile, batch, dtype):
    h = _halos(name, tile, batch, 42, dtype)
    got = execute_tiles(name, torch.from_numpy(h), tile)
    assert got.dtype == getattr(torch, dtype) and got.shape == (batch, *tile)
    tol = 1e-4 if dtype == "float32" else 1e-12
    pallas = np.asarray(jax_execute_tiles(name, jnp.asarray(h), tile, interpret=True))
    oracle = np.asarray(jax_execute_tiles_ref(name, jnp.asarray(h), tile))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=tol, atol=tol)


@pytest.mark.parametrize("name,tile", [("heat1d", (4, 4)), ("heat3d", (2, 2, 2, 2))])
def test_nd_stencil_matches_reference_kernel(name, tile):
    h = _halos(name, tile, 3, 3, "float64")
    got = execute_tiles(name, torch.from_numpy(h), tile)
    want = np.asarray(jax_execute_tiles(name, jnp.asarray(h), tile, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_execute_tiles_ref(name, jnp.asarray(h), tile)),
        rtol=1e-12, atol=1e-12)


def test_plain_version_is_the_wrapper_on_cpu_and_does_not_count():
    h = torch.from_numpy(_halos("gaussian", (4, 8, 8), 2, 7, "float32"))
    before = execute_tiles.launches
    got = execute_tiles("gaussian", h, (4, 8, 8))
    assert execute_tiles.launches == before == 0
    assert torch.equal(got, execute_tiles_ref("gaussian", h, (4, 8, 8)))
    # the halo buffer is read, never written
    assert torch.equal(h, torch.from_numpy(_halos("gaussian", (4, 8, 8), 2, 7, "float32")))


def test_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="3-D, tile is 2-D"):
        execute_tiles("jacobi2d5p", torch.zeros((1, 5, 6)), (4, 4))
    with pytest.raises(ValueError, match="halos must be"):
        execute_tiles("jacobi2d5p", torch.zeros((1, 5, 6, 7)), (4, 4, 4))
    with pytest.raises(TypeError, match="float32 or float64"):
        execute_tiles("jacobi2d5p", torch.zeros((1, 5, 6, 6), dtype=torch.int32),
                      (4, 4, 4))
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        execute_tiles("jacobi2d5p", torch.zeros((1, 5, 6, 6), device="meta"),
                      (4, 4, 4))
    with pytest.raises(KeyError, match="unknown benchmark"):
        execute_tiles("nope", torch.zeros((1, 5, 6, 6)), (4, 4, 4))


def test_packed_term_tables_pad_spatial_axes_to_three():
    combine, centre, n, depth, offs, values = stencil_mod._packed_terms("heat1d")
    assert n == 3 and depth.dtype == np.int32 and offs.dtype == np.int32
    assert offs.reshape(n, 3)[:, :2].tolist() == [[0, 0]] * 3
    assert offs.reshape(n, 3)[:, 2].tolist() == [-2, -1, 0]
    assert values.tolist() == [0.25, 0.5, 0.25]
    combine, centre, n, *_ = stencil_mod._packed_terms("jacobi2d9p-gol")
    assert (combine, n) == (2, 9) and 0 <= centre < n
    combine, centre, n, depth, *_ = stencil_mod._packed_terms("smith-waterman-3seq")
    assert (combine, n) == (1, 7) and depth.tolist() == [1, 1, 1, 2, 2, 2, 3]


def test_c_entry_point_matches_the_ctypes_binding():
    """The wrapper's argtypes and the .cu entry point agree in arity."""
    src = (SRC / "stencil" / "csrc" / "stencil_tiles.cu").read_text()
    sig = re.search(r'extern "C" int stencil_tiles\((.*?)\)\s*\{', src, re.S).group(1)
    n_params = len([p for p in sig.split(",") if p.strip()])
    tree = ast.parse((SRC / "stencil" / "stencil.py").read_text())
    argtypes = next(node.value for node in ast.walk(tree)
                    if isinstance(node, ast.Assign)
                    and any(getattr(t, "attr", None) == "argtypes" for t in node.targets))
    assert len(argtypes.elts) == n_params == 18


def test_build_plumbing_without_nvcc(tmp_path, monkeypatch):
    """Sources are found and named by content hash; no nvcc means a clear
    error, never a fallback."""
    assert set(_build.sources()) == {"stencil_tiles", "facet_fetch", "block_attention",
                                     "ssd_scan", "ssd_scan_bwd", "gated_rms_norm"}
    assert "-fmad=false" in _build.FLAGS and "--use_fast_math" not in _build.FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.FLAGS
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    lib = _build._library_path("stencil_tiles")
    assert lib.parent == tmp_path and re.fullmatch(r"libstencil_tiles_[0-9a-f]{16}\.so", lib.name)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library("stencil_tiles")


def _cluster_schedule(name: str, halos: np.ndarray, tile, plan, push=True) -> np.ndarray:
    """numpy transliteration of ``stencil_tiles_kernel`` under ``plan``
    (``push=False``: the control, no rows handed to the next CTA)."""
    combine, centre, n, depth, offs, values = stencil_mod._packed_terms(name)
    offs = offs.reshape(n, 3)
    dt = halos.dtype.type
    vals = [dt(v) for v in values]  # float64 values rounded to the tile's type
    prog = get_program(name)
    t, w = stencil_mod._padded(prog, tuple(tile))
    w0, t0 = prog.widths[0], tile[0]
    hext = tuple(a + b for a, b in zip(t, w))
    B = halos.shape[0]
    H = halos.reshape(B, w0 + t0, *hext)
    out = np.full((B, t0, *t), np.nan, halos.dtype)
    s, k, strip, ahead, R = plan.split, plan.k, plan.strip, plan.ahead, plan.ring
    E = plan.slot

    def parts(first: bool, ln: int) -> np.ndarray:
        """The slot elements plane p takes from the halo buffer."""
        u = np.meshgrid(*(np.arange(e) for e in E), indexing="ij")
        m = np.zeros(E, bool)
        for a in range(3):
            if a != s or first:
                m |= u[a] < w[a]
        m &= u[s] < w[s] + ln
        return m

    for b in range(B):
        rings, lens = [], []
        for rank in range(k):
            r0 = rank * strip
            ln = min(strip, t[s] - r0)
            lens.append(ln)
            ring = np.full((R, *E), np.nan, halos.dtype)
            sl = [slice(None)] * 3
            sl[s] = slice(r0, r0 + w[s] + ln)
            dsl = [slice(None)] * 3
            dsl[s] = slice(0, w[s] + ln)
            for p in range(-w0, 0):  # live-in planes, whole
                ring[(R + p) % R][tuple(dsl)] = H[b, w0 + p][tuple(sl)]
            rings.append(ring)

        def load(rank: int, p: int) -> None:
            r0, ln = rank * strip, lens[rank]
            m = parts(rank == 0, ln)
            src = np.full(E, np.nan, halos.dtype)
            sl = [slice(None)] * 3
            sl[s] = slice(r0, r0 + w[s] + ln)
            dsl = [slice(None)] * 3
            dsl[s] = slice(0, w[s] + ln)
            src[tuple(dsl)] = H[b, w0 + p][tuple(sl)]
            rings[rank][p % R][m] = src[m]

        for rank in range(k):
            for p in range(min(ahead, t0)):
                load(rank, p)
        for p in range(t0):
            for rank in range(k):
                if p + ahead < t0:
                    load(rank, p + ahead)
            for rank in range(k):
                ring, ln, r0 = rings[rank], lens[rank], rank * strip
                ext = [t[a] if a != s else ln for a in range(3)]

                def term(i: int) -> np.ndarray:
                    slot = ring[(p - depth[i]) % R]
                    return slot[tuple(slice(w[a] + offs[i][a], w[a] + offs[i][a] + ext[a])
                                      for a in range(3))]

                with np.errstate(invalid="ignore"):
                    if combine == COMBINE_SUM:
                        acc = term(0) * vals[0]
                        for i in range(1, n):
                            acc = acc + term(i) * vals[i]
                    elif combine == COMBINE_MAXPLUS:
                        acc = term(0) + vals[0]
                        for i in range(1, n):
                            acc = np.maximum(acc, term(i) + vals[i])
                    else:
                        assert combine == COMBINE_GOL
                        acc = term(0)
                        for i in range(1, n):
                            acc = acc + term(i)
                        acc = dt(2) * term(centre) + (-(acc / dt(9)))
                own = tuple(slice(w[a], w[a] + ext[a]) for a in range(3))
                ring[p % R][own] = acc
                osl = [slice(None)] * 3
                osl[s] = slice(r0, r0 + ln)
                out[b, p][tuple(osl)] = acc
                if push and rank + 1 < k:  # the last w_s rows: the upper neighbour's low-side halo
                    src = [slice(w[a], w[a] + ext[a]) for a in range(3)]
                    src[s] = slice(w[s] + ln - w[s], w[s] + ln)
                    dst = list(src)
                    dst[s] = slice(0, w[s])
                    rings[rank + 1][p % R][tuple(dst)] = ring[p % R][tuple(src)]
    return out.reshape(B, *tile)


SCHEDULE_CASES = [  # program, tile, batch, forced CTAs per tile (None: the plan's)
    ("jacobi2d5p", (4, 8, 8), 3, None), ("jacobi2d5p", (4, 8, 8), 3, 4),
    ("jacobi2d5p", (3, 10, 8), 2, 3),   # strips of 4, 4 and 2 rows
    ("jacobi2d5p", (6, 32, 2), 2, 4),   # the irredundant path's 2-wide last axis
    ("jacobi2d9p", (4, 8, 8), 3, 2), ("jacobi2d9p-gol", (4, 8, 8), 3, 4),
    ("gaussian", (4, 16, 16), 2, None), ("gaussian", (4, 16, 16), 2, 4),
    ("smith-waterman-3seq", (6, 8, 8), 3, 8),
    ("heat1d", (8, 32), 4, None), ("heat1d", (8, 32), 4, 8),
    ("heat3d", (2, 4, 4, 4), 3, 2),
]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name,tile,batch,k", SCHEDULE_CASES)
def test_cluster_schedule_is_bit_equal_to_the_plain_version(name, tile, batch, k, dtype):
    h = _halos(name, tile, batch, 11, dtype)
    plan = launch_plan(name, batch, tile, getattr(torch, dtype), k=k)
    if k is not None:
        assert plan.k == k and plan.ctas == batch * k
    got = _cluster_schedule(name, h, tile, plan)
    want = execute_tiles_ref(name, torch.from_numpy(h), tile).numpy()
    assert not np.isnan(got).any()
    assert got.tobytes() == want.tobytes()
    tol = 1e-4 if dtype == "float32" else 1e-12
    pallas = np.asarray(jax_execute_tiles(name, jnp.asarray(h), tile, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)


def test_the_schedule_needs_the_neighbour_rows_and_the_whole_ring():
    """Controls: without the lower neighbour's rows the transliteration
    reads unfilled (NaN) slots; with one ring slot fewer than w0+1+ahead
    the early halo loads overwrite a plane still being read."""
    h = _halos("jacobi2d5p", (4, 8, 8), 2, 3, "float32")
    want = execute_tiles_ref("jacobi2d5p", torch.from_numpy(h), (4, 8, 8)).numpy()
    plan = launch_plan("jacobi2d5p", 2, (4, 8, 8), k=4)
    assert plan.ahead >= 1
    assert _cluster_schedule("jacobi2d5p", h, (4, 8, 8), plan).tobytes() == want.tobytes()
    assert np.isnan(_cluster_schedule("jacobi2d5p", h, (4, 8, 8), plan, push=False)).any()
    short = stencil_mod.LaunchPlan(**{**plan.__dict__, "ring": plan.ring - 1})
    got = _cluster_schedule("jacobi2d5p", h, (4, 8, 8), short)
    assert got.tobytes() != want.tobytes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_launch_plan_at_the_path_shapes(dtype):
    """jacobi2d5p's main wave, the paper's 64^3 tile, the irredundant wave and
    the dataflow path's single tile: clusters of at most 8, shared memory
    within a block's 232448 B, every strip at least its halo width."""
    main = launch_plan("jacobi2d5p", 64, (2, 128, 128), dtype)
    cube = launch_plan("jacobi2d5p", 64, (64, 64, 64), dtype)
    irr = launch_plan("jacobi2d5p", 16, (16, 256, 2), dtype)
    one = launch_plan("jacobi2d5p", 1, (2, 128, 128), dtype)
    for plan, B in ((main, 64), (cube, 64), (irr, 16), (one, 1)):
        assert 1 <= plan.k <= stencil_mod.MAX_CLUSTER and plan.ctas == B * plan.k
        assert plan.smem <= stencil_mod.MAX_SMEM and plan.ctas_per_sm >= 1
        assert plan.split == 1 and plan.ring == 1 + 1 + plan.ahead
        assert plan.k == 1 or plan.strip >= 2
    assert main.ctas >= stencil_mod.N_SM and cube.ctas >= stencil_mod.N_SM
    assert one.k == stencil_mod.MAX_CLUSTER  # one tile: the widest cluster
    assert irr.slot[2] == 2 + 2  # the 2-wide last axis and its halo
    assert main.slot == (1, 2 + main.strip, 130)
    heat = launch_plan("heat1d", 4, (8, 32))  # padded extents (1, 1, 32): the last axis splits
    assert heat.split == 2


def test_every_program_has_a_kernel_for_its_table():
    """The source instantiates one kernel per (combine, term count) of the
    programs' tables; ``_launch`` rejects any other table."""
    for name in PROGRAMS:
        combine, _, n, *_ = stencil_mod._packed_terms(name)
        assert (combine, n) in stencil_mod.KERNEL_TABLES, name
    src = (SRC / "stencil" / "csrc" / "stencil_tiles.cu").read_text()
    names = {COMBINE_SUM: "kSum", COMBINE_MAXPLUS: "kMaxPlus", COMBINE_GOL: "kGol"}
    got = {(c, int(n)) for c in names
           for n in re.findall(rf"launch_one<T, {names[c]}, (\d+)>", src)}
    assert got == set(stencil_mod.KERNEL_TABLES)


def test_launch_plan_rejects_what_the_kernel_rejects():
    with pytest.raises(ValueError, match="no split into 3 strips"):
        launch_plan("heat3d", 3, (2, 4, 4, 4), k=3)  # strips of 1 row < halo width 2
    with pytest.raises(ValueError, match="no split into 9 strips"):
        launch_plan("jacobi2d5p", 1, (2, 128, 128), k=9)
    with pytest.raises(ValueError, match="fits 232448 B"):
        launch_plan("jacobi2d5p", 1, (2, 4096, 4096), torch.float64)


def test_per_port_wrapper_checks_once_per_call(monkeypatch):
    """1s checks and packs its arguments once per call, however many ports;
    on the CPU each shard runs the plain version."""
    calls = []
    check = stencil_mod._check

    def counting(*args, **kwargs):
        calls.append(args[0])
        return check(*args, **kwargs)

    monkeypatch.setattr(stencil_mod, "_check", counting)
    h = torch.from_numpy(_halos("jacobi2d5p", (4, 8, 8), 8, 5, "float64"))
    got = execute_tiles_sharded("jacobi2d5p", h, (4, 8, 8), port_mesh(4, "cpu"))
    assert calls == ["jacobi2d5p"]
    assert torch.equal(got, execute_tiles_ref("jacobi2d5p", h, (4, 8, 8)))
    with pytest.raises(ValueError, match="halos must be"):
        execute_tiles_sharded("jacobi2d5p", h[:, :, :-1], (4, 8, 8), port_mesh(4, "cpu"))
