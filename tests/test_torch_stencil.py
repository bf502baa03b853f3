"""The port's stencil tile executor wrapper (repro_torch.kernels.stencil)
on CPU tensors, where it runs the kernel's plain PyTorch version.

The CUDA kernel itself is held against this plain version on the card by
``chip_smoke.py`` (bit-exact, every program, both dtypes); here the plain
path is held against the reference package's Pallas kernel
(``interpret=True``) and its jnp oracle, with the parametrisation and
tolerance of ``tests/test_kernels.py``, and the wrapper's checks, launch
counter and build plumbing are pinned without a card.
"""
import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks in one process)
import jax.numpy as jnp

from repro.kernels.stencil import execute_tiles as jax_execute_tiles
from repro.kernels.stencil import execute_tiles_ref as jax_execute_tiles_ref
from repro_torch.core.cfa import get_program
from repro_torch.kernels import _build
from repro_torch.kernels.stencil import execute_tiles, execute_tiles_ref
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
    assert len(argtypes.elts) == n_params == 15


def test_build_plumbing_without_nvcc(tmp_path, monkeypatch):
    """Sources are found and named by content hash; no nvcc means a clear
    error, never a fallback."""
    assert set(_build.sources()) == {"stencil_tiles", "facet_fetch", "block_attention",
                                     "ssd_scan"}
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
