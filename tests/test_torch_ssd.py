"""The port's chunked Mamba2 SSD scan (repro_torch.kernels.ssd) on CPU
tensors, where the ``ssd_scan`` wrapper runs the kernel's plain PyTorch
version (``ssd_chunked_ref``).

The CUDA kernel itself is held against this plain version on the card by
``chip_smoke.py``.  Here, on inputs drawn with ``numpy.random.default_rng``
and handed to both packages:

* the plain path against the reference's Pallas kernel (``interpret=True``)
  and its sequential oracle ``ssd_scan_ref`` on ``tests/test_kernels.py``'s
  cases: y within 1e-4 (float32) and 5e-2 (bfloat16), the final state
  within 1e-4 — the reference's own tolerances;
* the port's sequential oracle against the reference's; chunk invariance
  (8 against 64); ``ssd_decode_step`` against the reference's and along the
  scan's trajectory;
* the float32 kernel's loop (serial cumsum, the causal half of the decay
  matrix only, state update after y), transliterated to numpy from
  ``csrc/ssd_scan.cu``, against the plain version — also where the masked
  half of exp(l_t - l_s) overflows;
* the bfloat16 kernel's schedule, transliterated to numpy: 16 state rows per
  CTA, chunks in order, L padded to a multiple of 16, the decay factored per
  16-row block (exp only on the diagonal block), the f32 operands W, x o wout
  and S split into hi/lo bf16 pairs (the tensor cores' two products) —
  against the plain version and the reference's Pallas kernel on bf16 inputs,
  ragged chunks (77, 8) and an overflowing decay included: y within one bf16
  rounding (2^-7 |want| + 1e-3), the state within 1e-4 + 1e-4 |want|; and the
  control, one bf16 rounding of x o wout, which must break the state limit;
* ``launch_plan`` at the serve shapes (>= 128 CTAs at batch 1, shared memory
  within a block's 232448 B) and what it rejects;
* ``T % chunk != 0`` and the other rejections, the launch counter and the C
  entry point's arity;
* the gradient: autograd through the port's ``ssd_scan`` on the CPU (the
  plain version) against ``jax.vjp`` of the reference model's
  ``_ssd_chunked`` with seeded cotangents for y and the final state, at the
  test shapes and through the model's padding path (T not a multiple of the
  chunk), float32, within 1e-5 max|want| + 1e-7;
* the backward kernel's four launches (``csrc/ssd_scan_bwd.cu``: the
  chunk-local U of every chunk into the dS_next scratch, the in-place
  state-passing pass, dx and dloga per head and chunk, dB and dC summed over
  the heads in order) transliterated to PyTorch in float64, against the
  plain backward (``ssd_chunked_bwd_ref``) within 1e-5 max|want|; the same
  transliteration with the bf16 route's operands (each float32 operand as
  hi/lo bf16 halves) within the card's limits at the training shape's chunk
  and state size, and one bf16 rounding of an operand beyond them;
  ``_SsdScan`` (the autograd function CUDA tensors go through) with its two
  launches replaced by plain stand-ins, against autograd; ``backward_plan``
  at every card shape (grids, scratch, shared memory within a block's
  232448 B; at the training shape every launch >= 132 CTAs) and the
  backward's C entry point's arity.
"""
import ast
import re
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax  # noqa: F401  (both frameworks in one process)
import jax.numpy as jnp

from repro.kernels.ssd import ssd_decode_step as jax_decode_step
from repro.models.mamba2 import _ssd_chunked as jax_ssd_chunked
from repro.kernels.ssd import ssd_scan as jax_ssd_scan
from repro.kernels.ssd import ssd_scan_ref as jax_ssd_scan_ref
from repro_torch.kernels.ssd import (ssd_chunked_bwd_ref, ssd_chunked_ref, ssd_decode_step,
                                     ssd_scan, ssd_scan_bwd, ssd_scan_ref)
from repro_torch.kernels.ssd import ssd as ssd_mod
from repro_torch.models.mamba2 import _ssd as port_ssd

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"

CASES = [  # tests/test_kernels.py's cases: B, T, H, P, N, chunk
    (2, 64, 4, 16, 8, 16),
    (1, 128, 2, 32, 16, 32),
    (2, 96, 8, 8, 4, 32),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


@pytest.fixture(autouse=True)
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)  # torch's default


def _inputs(seed, B, T, H, P, N, decay=0.5, scale_bc=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, H, P)).astype(np.float32)
    loga = (-np.abs(rng.normal(size=(B, T, H))) * decay).astype(np.float32)
    div = np.sqrt(N) if scale_bc else 1.0
    Bm = (rng.normal(size=(B, T, N)) / div).astype(np.float32)
    C = (rng.normal(size=(B, T, N)) / div).astype(np.float32)
    return x, loga, Bm, C


def _torch(x, loga, Bm, C, dtype=torch.float32):
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(loga),
            torch.from_numpy(Bm).to(dtype), torch.from_numpy(C).to(dtype))


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,T,H,P,N,chunk", CASES)
def test_plain_version_matches_reference_kernel_and_oracle(B, T, H, P, N, chunk, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, loga, Bm, C = _inputs(5, B, T, H, P, N)
    y, s = ssd_scan(*_torch(x, loga, Bm, C, tdt), chunk=chunk)
    assert y.dtype == tdt and y.shape == (B, T, H, P)
    assert s.dtype == torch.float32 and s.shape == (B, H, P, N)
    jx, jB, jC = (jnp.asarray(a, jdt) for a in (x, Bm, C))
    jy, js = jax_ssd_scan(jx, jnp.asarray(loga), jB, jC, chunk=chunk)
    ry, rs = jax_ssd_scan_ref(jx, jnp.asarray(loga), jB, jC)
    _close(y, jy, tol)
    _close(y, ry, tol)
    _close(s, js, 1e-4)
    _close(s, rs, 1e-4)


def test_sequential_oracle_matches_the_reference_oracle():
    x, loga, Bm, C = _inputs(6, 2, 24, 3, 8, 4)
    init = np.random.default_rng(1).normal(size=(2, 3, 8, 4)).astype(np.float32)
    y, s = ssd_scan_ref(*_torch(x, loga, Bm, C), init_state=torch.from_numpy(init))
    jy, js = jax_ssd_scan_ref(*(jnp.asarray(a) for a in (x, loga, Bm, C)),
                              init_state=jnp.asarray(init))
    _close(y, jy, 1e-5)
    _close(s, js, 1e-5)


def test_chunk_invariance():
    """The facet decomposition is invariant to the chunk size."""
    x, loga, Bm, C = _inputs(9, 1, 64, 2, 8, 4, decay=0.3, scale_bc=False)
    y8, s8 = ssd_scan(*_torch(x, loga, Bm, C), chunk=8)
    y64, s64 = ssd_scan(*_torch(x, loga, Bm, C), chunk=64)
    torch.testing.assert_close(y8, y64, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(s8, s64, rtol=2e-5, atol=2e-5)


def test_decode_step_matches_reference_and_follows_the_scan():
    x, loga, Bm, C = _inputs(13, 2, 16, 2, 8, 4, decay=0.3, scale_bc=False)
    tx, tl, tB, tC = _torch(x, loga, Bm, C)
    y_ref, s_ref = ssd_scan_ref(tx, tl, tB, tC)
    S = torch.zeros((2, 2, 8, 4))
    jS = jnp.zeros((2, 2, 8, 4), jnp.float32)
    for t in range(16):
        y_t, S = ssd_decode_step(S, tx[:, t], tl[:, t], tB[:, t], tC[:, t])
        jy_t, jS = jax_decode_step(jS, *(jnp.asarray(a[:, t]) for a in (x, loga, Bm, C)))
        _close(y_t, jy_t, 1e-6)
        _close(S, jS, 1e-6)
        torch.testing.assert_close(y_t, y_ref[:, t], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(S, s_ref, rtol=1e-5, atol=1e-5)


def test_decode_step_keeps_the_token_dtype():
    x, loga, Bm, C = _inputs(2, 1, 1, 2, 4, 4)
    y, S = ssd_decode_step(torch.zeros((1, 2, 4, 4)), *_torch(x[:, 0], loga[:, 0], Bm[:, 0],
                                                              C[:, 0], torch.bfloat16))
    assert y.dtype == torch.bfloat16 and S.dtype == torch.float32


def _kernel_loop(x, loga, Bm, C, L):
    """numpy transliteration of csrc/ssd_scan.cu for one launch: per (row,
    head), chunks in order; serial cumsum; W only for s <= t; y from the
    state before the chunk; then the state update."""
    Bb, T, H, P = x.shape
    N = Bm.shape[-1]
    y = np.zeros((Bb, T, H, P), np.float32)
    state = np.zeros((Bb, H, P, N), np.float32)
    with np.errstate(over="raise", invalid="raise"):
        for b in range(Bb):
            for h in range(H):
                S = np.zeros((P, N), np.float32)
                for c0 in range(0, T, L):
                    xs = x[b, c0:c0 + L, h].astype(np.float32)  # (L, P)
                    Bc = Bm[b, c0:c0 + L].astype(np.float32)
                    Cc = C[b, c0:c0 + L].astype(np.float32)
                    lcum = np.cumsum(loga[b, c0:c0 + L, h].astype(np.float32))
                    W = np.zeros((L, L), np.float32)
                    for t in range(L):
                        s = np.arange(t + 1)
                        W[t, :t + 1] = np.exp(lcum[t] - lcum[s]) * (Bc[s] @ Cc[t])
                    y[b, c0:c0 + L, h] = W @ xs + np.exp(lcum)[:, None] * (Cc @ S.T)
                    wout = np.exp(lcum[-1] - lcum)
                    S = np.exp(lcum[-1]) * S + (xs * wout[:, None]).T @ Bc
                state[b, h] = S
    return y, state


@pytest.mark.parametrize("B,T,H,P,N,L,decay", [
    (2, 64, 4, 16, 8, 16, 0.5),
    (1, 24, 2, 8, 4, 8, 0.5),     # the smoke configs' chunk
    (1, 256, 2, 4, 8, 128, 3.0),  # exp(l_t - l_s) overflows in the masked half
])
def test_the_kernels_loop_matches_the_plain_version(B, T, H, P, N, L, decay):
    x, loga, Bm, C = _inputs(17, B, T, H, P, N, decay=decay)
    y, s = ssd_scan(*_torch(x, loga, Bm, C), chunk=L)
    ky, ks = _kernel_loop(x, loga, Bm, C, L)
    assert np.isfinite(ky).all() and torch.isfinite(y).all()
    np.testing.assert_allclose(ky, y.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ks, s.numpy(), rtol=1e-4, atol=1e-4)


def _bf16(a) -> np.ndarray:
    """f32 -> bf16 (round to nearest even, as __float2bfloat16_rn) -> f32."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16).float().numpy()


def _mma_schedule(x, loga, Bm, C, L, split=True):
    """numpy transliteration of ``ssd_scan_mma_kernel``: per (row, head,
    16-row block of p) CTA, chunks in order; the chunk padded to Lp = 16k
    rows (zero x, B, C and log-decay); G = C B^T; W = G o decay with the
    decay factored as R[t] M[tb][jj] Q[s] below the diagonal 16x16 block and
    exp(l_t - l_s), s <= t only, on it; W, S and x o wout split into bf16
    hi/lo halves (``split=False``: x o wout rounded once, the control); y =
    W x + E[t] C S^T; S <- exp(l_L) S + (x o wout)^T B.  Any exp overflow
    raises."""
    Bb, T, H, P = x.shape
    N = Bm.shape[-1]
    nblk = -(-L // 16)
    Lp = 16 * nblk
    t_idx = np.arange(Lp)
    blk = t_idx // 16
    y = np.zeros((Bb, T, H, P), np.float32)
    state = np.zeros((Bb, H, P, N), np.float32)
    with np.errstate(over="raise", invalid="raise"):
        for b in range(Bb):
            for h in range(H):
                for p0 in range(0, P, 16):
                    pw = min(16, P - p0)
                    S = np.zeros((16, N), np.float32)
                    for c0 in range(0, T, L):
                        xs = np.zeros((Lp, 16), np.float32)
                        xs[:L, :pw] = x[b, c0:c0 + L, h, p0:p0 + pw]
                        Bc = np.zeros((Lp, N), np.float32)
                        Cc = np.zeros((Lp, N), np.float32)
                        la = np.zeros(Lp, np.float32)
                        Bc[:L], Cc[:L] = Bm[b, c0:c0 + L], C[b, c0:c0 + L]
                        la[:L] = loga[b, c0:c0 + L, h]
                        lcum = np.cumsum(la, dtype=np.float32)
                        ltot = lcum[L - 1]
                        anchor = lcum[16 * np.arange(nblk) + 15]
                        R = np.ones(Lp, np.float32)
                        R[16:] = np.exp(lcum[16:] - anchor[blk[16:] - 1])
                        Q = np.exp(anchor[blk] - lcum).astype(np.float32)
                        E = np.exp(lcum).astype(np.float32)
                        G = Cc @ Bc.T
                        W = np.zeros((Lp, Lp), np.float32)
                        for tb in range(nblk):
                            rows = slice(16 * tb, 16 * tb + 16)
                            for jj in range(tb):
                                cols = slice(16 * jj, 16 * jj + 16)
                                m = np.float32(np.exp(anchor[tb - 1] - anchor[jj]))
                                W[rows, cols] = (G[rows, cols] * (R[rows] * m)[:, None]
                                                 * Q[cols][None, :])
                            tt, ss = np.meshgrid(t_idx[rows], t_idx[rows], indexing="ij")
                            low = ss <= tt
                            dec = np.zeros((16, 16), np.float32)
                            dec[low] = np.exp(lcum[tt[low]] - lcum[ss[low]])
                            W[rows, rows] = np.where(low, G[rows, rows] * dec, 0)
                        Wh, Sh = _bf16(W), _bf16(S)
                        Wl, Sl = _bf16(W - Wh), _bf16(S - Sh)
                        yc = (Wh @ xs + Wl @ xs) + E[:, None] * (Cc @ Sh.T + Cc @ Sl.T)
                        y[b, c0:c0 + L, h, p0:p0 + pw] = yc[:L, :pw]
                        xw = xs * np.exp(ltot - lcum).astype(np.float32)[:, None]
                        xh = _bf16(xw)
                        xl = _bf16(xw - xh) if split else np.zeros_like(xw)
                        S = np.float32(np.exp(ltot)) * S + (xh.T @ Bc + xl.T @ Bc)
                    state[b, h, p0:p0 + pw] = S[:pw]
    return y, state


def _excess(got, want, rtol, atol) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 within the limit."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (atol + rtol * np.abs(want))).max())


Y_BF16_TOL = (2.0 ** -7, 1e-3)  # one bf16 output rounding
STATE_TOL = (1e-4, 1e-4)


def _bf16_inputs(seed, B, T, H, P, N, decay):
    x, loga, Bm, C = _inputs(seed, B, T, H, P, N, decay=decay)
    return _bf16(x), loga, _bf16(Bm), _bf16(C)


@pytest.mark.parametrize("B,T,H,P,N,L,decay", [
    (1, 154, 2, 16, 16, 77, 0.5),  # a ragged chunk (the serve stream's short prompts)
    (2, 24, 2, 8, 4, 8, 0.5),      # the smoke configs' chunk; P and N below one block
    (1, 256, 2, 4, 8, 128, 3.0),   # exp(l_t - l_s) overflows in the masked half
    (1, 128, 3, 32, 32, 64, 0.5),  # two p-blocks per head
])
def test_the_bf16_kernels_schedule_matches_the_plain_version(B, T, H, P, N, L, decay):
    x, loga, Bm, C = _bf16_inputs(23, B, T, H, P, N, decay)
    y, s = _mma_schedule(x, loga, Bm, C, L)
    assert np.isfinite(y).all() and np.isfinite(s).all()
    wy, ws = ssd_scan(*_torch(x, loga, Bm, C, torch.bfloat16), chunk=L)
    assert _excess(_bf16(y), wy.float().numpy(), *Y_BF16_TOL) <= 1.0
    assert _excess(s, ws.numpy(), *STATE_TOL) <= 1.0
    jy, js = jax_ssd_scan(*(jnp.asarray(a, jnp.bfloat16) if a is not loga else jnp.asarray(a)
                            for a in (x, loga, Bm, C)), chunk=L)
    assert _excess(_bf16(y), np.asarray(jy, np.float32), *Y_BF16_TOL) <= 1.0
    assert _excess(s, np.asarray(js), *STATE_TOL) <= 1.0


@pytest.mark.parametrize("B,T,H,P,N,L", [(1, 256, 2, 16, 128, 128), (2, 24, 2, 8, 4, 8)])
def test_one_bf16_rounding_of_x_wout_breaks_the_state_limit_and_the_split_meets_it(
        B, T, H, P, N, L):
    x, loga, Bm, C = _bf16_inputs(29, B, T, H, P, N, 0.5)
    _, ws = ssd_chunked_ref(*_torch(x, loga, Bm, C, torch.bfloat16), L)
    _, split = _mma_schedule(x, loga, Bm, C, L)
    _, once = _mma_schedule(x, loga, Bm, C, L, split=False)
    assert _excess(split, ws.numpy(), *STATE_TOL) <= 0.5
    assert _excess(once, ws.numpy(), *STATE_TOL) > 2.0


@pytest.mark.parametrize("B", [1, 4])
def test_launch_plan_at_the_serve_shapes(B):
    """mamba2-370m's prefill: H 32, P 64, N 128, chunk 128 (and a short prompt)."""
    plan = ssd_mod.launch_plan(B, 1024, 32, 64, 128, 128, torch.bfloat16)
    assert plan.route == "mma" and plan.grid == (4, 32, B) and plan.ctas == 128 * B
    assert plan.smem <= ssd_mod.MAX_SMEM and plan.stages == 2 and plan.ctas_per_sm >= 1
    assert plan.ctas == plan.grid[0] * 32 * B and ssd_mod.P_BLOCK * plan.grid[0] >= 64
    assert (plan.lp, plan.np_) == (128, 128)
    short = ssd_mod.launch_plan(B, 77, 32, 64, 128, 77, torch.bfloat16)
    assert short.lp == 80 and short.ctas >= 128 and short.smem <= ssd_mod.MAX_SMEM
    f32 = ssd_mod.launch_plan(B, 1024, 32, 64, 128, 128, torch.float32)
    assert f32.route == "fma" and f32.grid == plan.grid and f32.smem <= ssd_mod.MAX_SMEM
    # the largest state size takes one staging stage
    big = ssd_mod.launch_plan(1, 128, 1, 64, ssd_mod.MAX_STATE, 128, torch.bfloat16)
    assert big.stages == 1 and big.smem <= ssd_mod.MAX_SMEM


def test_launch_plan_rejects_what_the_kernel_rejects():
    with pytest.raises(ValueError, match="chunk 129 outside"):
        ssd_mod.launch_plan(1, 129, 2, 16, 16, 129)
    with pytest.raises(ValueError, match="state size N=257"):
        ssd_mod.launch_plan(1, 128, 2, 16, 257, 128)
    with pytest.raises(ValueError, match="<= 65535"):
        ssd_mod.launch_plan(1, 128, 70000, 16, 16, 128)
    with pytest.raises(TypeError, match="no ssd_scan route"):
        ssd_mod.launch_plan(1, 128, 2, 16, 16, 128, torch.float16)


def test_plain_version_is_the_wrapper_on_cpu_and_does_not_count():
    args = _torch(*_inputs(1, 1, 32, 2, 4, 4))
    before = [a.clone() for a in args]
    ssd_scan.launches = 0
    y, s = ssd_scan(*args, chunk=8)
    assert ssd_scan.launches == 0
    wy, ws = ssd_chunked_ref(*args, 8)
    assert torch.equal(y, wy) and torch.equal(s, ws)
    assert all(torch.equal(a, b) for a, b in zip(args, before))  # read only


def test_rejects_what_the_kernel_does_not_take():
    x, loga, Bm, C = _torch(*_inputs(1, 1, 24, 2, 4, 4))
    with pytest.raises(ValueError, match="T=24 must divide by chunk=16"):
        ssd_scan(x, loga, Bm, C, chunk=16)
    with pytest.raises(ValueError, match="must divide by chunk"):
        ssd_chunked_ref(x, loga, Bm, C, 16)
    with pytest.raises(ValueError, match="do not match"):
        ssd_scan(x, loga[:, :, :1], Bm, C, chunk=8)
    with pytest.raises(ValueError, match="want x"):
        ssd_scan(x, loga, Bm, C[..., :2], chunk=8)
    with pytest.raises(ValueError, match="CUDA device, the CPU or meta"):
        ssd_scan(*(a.as_subclass(_Elsewhere) for a in (x, loga, Bm, C)), chunk=8)
    with pytest.raises(ValueError, match="CUDA device, the CPU or meta"):
        ssd_scan_bwd(*(a.as_subclass(_Elsewhere) for a in (x, loga, Bm, C, x)), chunk=8)


class _Elsewhere(torch.Tensor):
    """A tensor that reports a device the wrappers do not take."""

    @property
    def device(self):
        return torch.device("xpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_tensors_propagate_the_shapes_of_the_cpu_outputs(dtype):
    """A dry run's ``meta`` tensors: the kernel's checks, then the plain
    version's shapes and dtypes — outputs and gradients alike."""
    cpu = [t.requires_grad_() for t in _torch(*_inputs(3, 2, 32, 3, 8, 4), dtype=dtype)]
    meta = [t.detach().to("meta").requires_grad_() for t in cpu]
    ssd_scan.launches = ssd_scan_bwd.launches = 0
    outs = {}
    for name, args in (("cpu", cpu), ("meta", meta)):
        y, s = ssd_scan(*args, chunk=8)
        grads = torch.autograd.grad((y.float().sum() + s.sum()), args)
        outs[name] = [y, s, *grads]
        dx = ssd_scan_bwd(*(a.detach() for a in args), y.detach(), s.detach(), chunk=8)
        outs[name] += list(dx)
    assert ssd_scan.launches == ssd_scan_bwd.launches == 0
    for c, m in zip(outs["cpu"], outs["meta"]):
        assert m.device.type == "meta"
        assert (m.shape, m.dtype) == (c.shape, c.dtype)
    # the kernel's own checks run on meta too
    with pytest.raises(TypeError, match="loga must be float32"):
        ssd_scan(meta[0], meta[1].to(torch.float64), meta[2], meta[3], chunk=8)


def test_a_dtensor_raises():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    x, loga, Bm, C = _torch(*_inputs(1, 1, 16, 2, 4, 4))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        xd = distribute_tensor(x, mesh)
        with pytest.raises(TypeError, match="not DTensors"):
            ssd_scan(xd, loga, Bm, C, chunk=8)
        with pytest.raises(TypeError, match="not DTensors"):
            ssd_scan_bwd(x, loga, Bm, C, xd, chunk=8)
    finally:
        dist.destroy_process_group()


def test_c_entry_point_matches_the_ctypes_binding():
    """The wrapper's argtypes and the .cu entry point agree in arity."""
    src = (SRC / "ssd" / "csrc" / "ssd_scan.cu").read_text()
    sig = re.search(r'extern "C" int ssd_scan\((.*?)\)\s*\{', src, re.S).group(1)
    n_params = len([p for p in sig.split(",") if p.strip()])
    tree = ast.parse((SRC / "ssd" / "ssd.py").read_text())
    argtypes = next(node.value for node in ast.walk(tree)
                    if isinstance(node, ast.Assign)
                    and any(getattr(t, "attr", None) == "argtypes" for t in node.targets))
    assert len(argtypes.elts) == n_params == 15


@pytest.mark.cuda
def test_cuda_tensors_launch_the_kernel_never_the_plain_version(monkeypatch):
    """On a card the wrapper launches the kernel (and counts it); the plain
    version is never its way out."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    B, T, H, P, N, chunk = CASES[0]
    args = [a.cuda() for a in _torch(*_inputs(5, B, T, H, P, N))]
    wy, ws = ssd_chunked_ref(*args, chunk)

    def plain(*a, **k):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(ssd_mod, "ssd_chunked_ref", plain)
    before = ssd_scan.launches
    y, s = ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    torch.testing.assert_close(y, wy, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, ws, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the gradient
# ---------------------------------------------------------------------------

GRAD_TOL = (1e-5, 1e-7)  # (relative to max|want|, absolute)


def _grad_close(got: torch.Tensor, want, tol=GRAD_TOL):
    want = np.asarray(want, np.float64)
    err = np.abs(got.detach().double().numpy() - want).max()
    assert err <= tol[0] * np.abs(want).max() + tol[1], (err, np.abs(want).max())


def _cotangents(seed, B, T, H, P, N):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, H, P)).astype(np.float32),
            rng.normal(size=(B, H, P, N)).astype(np.float32))


@pytest.mark.parametrize("B,T,H,P,N,chunk", CASES + [(2, 50, 3, 8, 4, 16)])
def test_gradient_matches_the_reference_models_ssd(B, T, H, P, N, chunk):
    """dx, dloga, dB, dC through the port's SSD on the CPU (the model's
    ``_ssd``: the padding path where T % chunk != 0) against ``jax.vjp``
    of the reference's ``_ssd_chunked``, cotangents for y and the state."""
    x, loga, Bm, C = _inputs(31, B, T, H, P, N)
    dy, ds = _cotangents(32, B, T, H, P, N)
    args = [a.requires_grad_() for a in _torch(x, loga, Bm, C)]
    y, s = port_ssd(*args, chunk)
    got = torch.autograd.grad([y, s], args, [torch.from_numpy(dy), torch.from_numpy(ds)])
    _, vjp = jax.vjp(lambda *a: jax_ssd_chunked(*a, chunk), *(jnp.asarray(a) for a in
                                                               (x, loga, Bm, C)))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    for g, w in zip(got, want):
        _grad_close(g, w)


def _bwd_launches(x, loga, Bm, C, dy, dstate, L, rnd=None):
    """The four launches of ``ssd_scan_bwd.cu``, in float64.  (1) ``local``:
    per (row, chunk, head) U_c = (exp(l) o dy)^T C into slot c - 1 of the
    dS_next scratch, the final state's gradient (or 0) into slot nc - 1, the
    chunk's decay exp(l_L); G^T = B C^T per chunk; (2) ``pass``: slot c <-
    decay_{c+1} slot c+1 + slot c, from the last chunk to the first, in
    place; (3) ``head``, per (row, chunk, head): Y = C S_prev^T, Z = B
    dS_next^T, dx = W^T dy + exp(l_L - l_s) Z, A^T = W^T o (x dy^T), dl =
    column sums - row sums of A^T + exp(l_t) dy . Y - exp(l_L - l_t) x . Z,
    the last step's terms, and dloga its reverse cumsum; (4) ``cross``, per
    (row, chunk), over the heads in order: dG += [s<=t] exp(l_t - l_s) dy_t .
    x_s, dC += exp(l_t) dy S_prev, dB += exp(l_L - l_s) x dS_next; then dC +=
    dG B and dB += dG^T C.  ``rnd(name, v)``, where given, is what the
    tensor cores see of each float32 operand (``"ady"``: exp(l) o dy, ``"W"``,
    ``"S"``: S_prev, ``"dS"``: dS_next, ``"dG"``); the other operand of each
    product (x, dy, B or C) goes in as it is."""
    x, loga, Bm, C, dy = (torch.as_tensor(a).double() for a in (x, loga, Bm, C, dy))
    op = rnd or (lambda name, v: v)
    Bb, T, H, P = x.shape
    N, nc = Bm.shape[-1], T // L
    xc, dyc = x.reshape(Bb, nc, L, H, P), dy.reshape(Bb, nc, L, H, P)
    Bc, Cc = Bm.reshape(Bb, nc, L, N), C.reshape(Bb, nc, L, N)
    lc = torch.cumsum(loga.reshape(Bb, nc, L, H), 2)
    ltot = lc[:, :, -1]  # (B, nc, H)
    el, wout = torch.exp(lc), torch.exp(ltot[:, :, None] - lc)  # (B, nc, L, H)
    states = torch.zeros(Bb, nc, H, P, N, dtype=torch.float64)  # the forward's saved states
    S = torch.zeros(Bb, H, P, N, dtype=torch.float64)
    for c in range(nc):
        states[:, c] = S
        S = torch.exp(ltot[:, c])[..., None, None] * S + torch.einsum(
            "blhp,bln->bhpn", xc[:, c] * wout[:, c, ..., None], Bc[:, c])
    # 1. local
    U = torch.einsum("bclhp,bcln->bchpn", op("ady", el[..., None] * dyc), Cc)
    dstates = torch.zeros_like(states)
    dstates[:, :-1] = U[:, 1:]
    if dstate is not None:
        dstates[:, -1] = torch.as_tensor(dstate).double()
    decay = torch.exp(ltot)
    GT = torch.einsum("bcsn,bctn->bcst", Bc, Cc)
    # 2. pass
    for c in range(nc - 2, -1, -1):
        dstates[:, c] = decay[:, c + 1][..., None, None] * dstates[:, c + 1] + dstates[:, c]
    # 3. head: [b, c, s, t, h] with t >= s
    ts = torch.arange(L)[None, :] >= torch.arange(L)[:, None]
    ldiff = lc[:, :, None, :, :] - lc[:, :, :, None, :]
    dec = torch.where(ts[..., None], torch.exp(torch.where(ts[..., None], ldiff, 0.0)), 0.0)
    WT = GT[..., None] * dec
    Y = torch.einsum("bctn,bchpn->bcthp", Cc, op("S", states))
    Z = torch.einsum("bcsn,bchpn->bcshp", Bc, op("dS", dstates))
    dx = torch.einsum("bcsth,bcthp->bcshp", op("W", WT), dyc) + wout[..., None] * Z
    AT = WT * torch.einsum("bcshp,bcthp->bcsth", xc, dyc)
    xz = (xc * Z).sum(-1)
    dl = AT.sum(2) - AT.sum(3) + el * (dyc * Y).sum(-1) - wout * xz
    dl[:, :, -1] += decay * (dstates * states).sum((-1, -2)) + (wout * xz).sum(2)
    dloga = torch.flip(torch.cumsum(torch.flip(dl, [2]), 2), [2])
    # 4. cross: the sums over heads, in head order
    dG = torch.zeros(Bb, nc, L, L, dtype=torch.float64)
    dCi, dBi = torch.zeros_like(Cc), torch.zeros_like(Bc)
    for h in range(H):
        E = dec[..., h].transpose(-1, -2) * torch.einsum("bctp,bcsp->bcts", dyc[..., h, :],
                                                         xc[..., h, :])
        dG += E
        dCi += el[..., h, None] * torch.einsum("bctp,bcpn->bctn", dyc[..., h, :],
                                               op("S", states[:, :, h]))
        dBi += wout[..., h, None] * torch.einsum("bcsp,bcpn->bcsn", xc[..., h, :],
                                                 op("dS", dstates[:, :, h]))
    dC = torch.einsum("bcts,bcsn->bctn", op("dG", dG), Bc) + dCi
    dB = torch.einsum("bcts,bctn->bcsn", op("dG", dG), Cc) + dBi
    return (dx.reshape(Bb, T, H, P), dloga.reshape(Bb, T, H), dB.reshape(Bb, T, N),
            dC.reshape(Bb, T, N))


@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("B,T,H,P,N,L", [(2, 64, 4, 16, 8, 16), (1, 96, 3, 5, 7, 32),
                                         (2, 24, 2, 8, 4, 8), (1, 154, 2, 16, 16, 77)])
def test_the_backward_kernels_launches_match_the_plain_backward(B, T, H, P, N, L, with_dstate):
    x, loga, Bm, C = _inputs(37, B, T, H, P, N)
    dy, ds = _cotangents(38, B, T, H, P, N)
    ds = ds if with_dstate else None
    got = _bwd_launches(x, loga, Bm, C, dy, ds, L)
    want = ssd_chunked_bwd_ref(*_torch(x, loga, Bm, C), torch.from_numpy(dy),
                               None if ds is None else torch.from_numpy(ds), L)
    for g, w in zip(got, want):
        _grad_close(g, w.numpy(), (1e-5, 0.0))


def test_the_autograd_function_saves_the_states_and_feeds_the_backward(monkeypatch):
    """``_SsdScan`` (CUDA tensors that need a gradient) with its launches
    replaced by plain stand-ins: the forward's per-chunk states reach the
    backward, a final state that is not used gives no dstate, and the
    gradients equal autograd through the plain version."""
    B, T, H, P, N, L = 2, 64, 4, 16, 8, 16
    x, loga, Bm, C = _inputs(41, B, T, H, P, N)
    dy, _ = _cotangents(42, B, T, H, P, N)
    seen = {}

    def fwd(x, loga, Bmat, C, chunk, save_states):
        y, s = ssd_chunked_ref(x, loga, Bmat, C, chunk)
        states = torch.stack([ssd_chunked_ref(x[:, :c * chunk], loga[:, :c * chunk],
                                              Bmat[:, :c * chunk], C[:, :c * chunk], chunk)[1]
                              if c else torch.zeros_like(s) for c in range(T // chunk)], 1)
        return y, s, states if save_states else None

    def bwd(x, loga, Bmat, C, dy, dstate, *, chunk, states):
        seen.update(states=states, dstate=dstate, chunk=chunk)
        return tuple(g.to(t.dtype) for g, t in zip(
            _bwd_launches(x, loga, Bmat, C, dy, dstate, chunk), (x, loga, Bmat, C)))

    monkeypatch.setattr(ssd_mod, "_forward", fwd)
    monkeypatch.setattr(ssd_mod, "ssd_scan_bwd", bwd)
    args = [a.requires_grad_() for a in _torch(x, loga, Bm, C)]
    y, _ = ssd_mod._SsdScan.apply(*args, L)
    got = torch.autograd.grad(y, args, torch.from_numpy(dy))
    assert seen["chunk"] == L and seen["dstate"] is None
    assert seen["states"].shape == (B, T // L, H, P, N)
    want = ssd_chunked_bwd_ref(*(a.detach() for a in args), torch.from_numpy(dy), None, L)
    for g, w in zip(got, want):
        _grad_close(g, w.numpy())


def test_the_backward_wrapper_on_cpu_is_the_plain_version_and_does_not_count():
    x, loga, Bm, C = _torch(*_inputs(43, 1, 32, 2, 4, 4))
    dy = torch.from_numpy(_cotangents(44, 1, 32, 2, 4, 4)[0])
    ssd_scan_bwd.launches = 0
    got = ssd_scan_bwd(x, loga, Bm, C, dy, chunk=8)
    assert ssd_scan_bwd.launches == 0
    want = ssd_chunked_bwd_ref(x, loga, Bm, C, dy, None, 8)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="dy"):
        ssd_scan_bwd(x, loga, Bm, C, dy[:, :8], chunk=8)


#: every shape the card runs the backward at: chip_smoke.py's SSD_CASES, a
#: short prompt's chunk and mamba2-370m's training shape
BWD_SHAPES = [(2, 64, 4, 16, 8, 16), (1, 128, 2, 32, 16, 32), (2, 96, 8, 8, 4, 32),
              (1, 1024, 32, 64, 128, 128), (4, 1024, 32, 64, 128, 128),
              (1, 256, 2, 64, 256, 128), (1, 64, 8, 16, 16, 8), (1, 77, 32, 64, 128, 77),
              (8, 4096, 32, 64, 128, 128)]
#: the H100's SMs; shared memory an SM holds (1 KiB of it reserved per CTA)
SMS, SM_SMEM = 132, 233472


@pytest.mark.parametrize("B,T,H,P,N,L", BWD_SHAPES)
def test_backward_plan_fits_shared_memory_at_every_card_shape(B, T, H, P, N, L):
    nc, lp = T // L, -(-L // 16) * 16
    for dtype, route in ((torch.bfloat16, "mma"), (torch.float32, "fma")):
        plan = ssd_mod.backward_plan(B, T, H, P, N, L, dtype)
        assert plan.route == route and tuple(plan.grids) == ssd_mod.BWD_LAUNCHES
        assert max(plan.smem.values()) <= ssd_mod.MAX_SMEM and plan.smem["pass"] == 0
        assert plan.grids["local"] == ((H + 1) * nc, B, 1)
        assert plan.grids["head"] == (H * nc, B, 1)
        assert plan.grids["cross"] == (2 * -(-N // 64) * nc, B, 1)
        per = 4 if P * N % 4 == 0 else 1
        assert plan.grids["pass"] == (-(-(H * P * N // per) // ssd_mod.BWD_THREADS), B, 1)
        assert plan.saved == 4 * B * nc * H * P * N
        assert plan.scratch == plan.saved + 4 * B * nc * lp * lp + 4 * B * nc * H * (5 * lp + 64)
    if (B, T) == (8, 4096):  # mamba2-370m's training shape
        plan = ssd_mod.backward_plan(B, T, H, P, N, L)
        assert plan.saved == 8 * 32 * 32 * 64 * 128 * 4 == 268435456
        # every launch has at least one CTA per SM of the card
        assert min(plan.ctas.values()) >= SMS, plan.ctas
        # two CTAs of the head and cross launches share an SM
        assert all(2 * (plan.smem[k] + 1024) <= SM_SMEM for k in ("head", "cross")), plan.smem


def test_backward_plan_rejects_what_the_kernels_reject():
    with pytest.raises(ValueError, match="chunk 129 outside"):
        ssd_mod.backward_plan(1, 129, 2, 16, 16, 129)
    with pytest.raises(ValueError, match="state size N=257"):
        ssd_mod.backward_plan(1, 128, 2, 16, 257, 128)
    with pytest.raises(ValueError, match="must divide"):
        ssd_mod.backward_plan(1, 100, 2, 16, 16, 64)
    with pytest.raises(TypeError, match="no ssd_scan_bwd route"):
        ssd_mod.backward_plan(1, 128, 2, 16, 16, 128, torch.float16)


def test_the_backward_c_entry_point_matches_its_ctypes_binding():
    src = (SRC / "ssd" / "csrc" / "ssd_scan_bwd.cu").read_text()
    sig = re.search(r'extern "C" int ssd_scan_bwd\((.*?)\)\s*\{', src, re.S).group(1)
    n_params = len([p for p in sig.split(",") if p.strip()])
    tree = ast.parse((SRC / "ssd" / "ssd.py").read_text())
    fn = next(node for node in tree.body
              if isinstance(node, ast.FunctionDef) and node.name == "_bwd_kernel")
    argtypes = next(node.value for node in ast.walk(fn) if isinstance(node, ast.Assign)
                    and any(getattr(t, "attr", None) == "argtypes" for t in node.targets))
    assert len(argtypes.elts) == n_params == 22


def _bf16_round(v: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 -> bf16 (round to nearest even) -> float64."""
    return v.float().bfloat16().double()


def _hi_lo(v: torch.Tensor) -> torch.Tensor:
    """What two MMAs see of an f32 value split into bf16 halves: hi + lo."""
    hi = _bf16_round(v)
    return hi + _bf16_round(v.float().double() - hi)


def _bwd_excess(got, want) -> list[float]:
    """chip_smoke.py's limits: dx, dB and dC (bf16, rounded once) within one
    output rounding, 2^-7 |want| + 1e-3; dloga within 1e-4 max|want| + 1e-6."""
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        w = w.double()
        if i == 1:
            out.append(float(((g - w).abs() / (1e-4 * w.abs().max() + 1e-6)).max()))
        else:
            out.append(_excess(_bf16(g.numpy()), w.numpy(), *Y_BF16_TOL))
    return out


@pytest.mark.parametrize("operand", ["dS", "S", "ady", "dG"])
def test_one_bf16_rounding_of_an_f32_operand_breaks_the_backward_limit_and_the_split_meets_it(
        operand):
    """The bf16 route at the training shape's chunk and state size (L 128, N
    128), in float64: each float32 operand of the tensor cores as hi/lo
    halves (the kernels) meets the card's limits against the plain backward;
    one bf16 rounding of dS_next, S_prev, exp(l) o dy or dG breaks them."""
    B, T, H, P, N, L = 1, 256, 2, 16, 128, 128
    x, loga, Bm, C = _bf16_inputs(47, B, T, H, P, N, 0.5)
    dy = _bf16(_cotangents(48, B, T, H, P, N)[0])
    want = ssd_chunked_bwd_ref(*_torch(x, loga, Bm, C, torch.bfloat16),
                               torch.from_numpy(dy).bfloat16(), None, L)
    split = _bwd_excess(_bwd_launches(x, loga, Bm, C, dy, None, L, rnd=lambda n, v: _hi_lo(v)),
                        want)
    once = _bwd_excess(_bwd_launches(
        x, loga, Bm, C, dy, None, L,
        rnd=lambda n, v: _bf16_round(v) if n == operand else _hi_lo(v)), want)
    assert max(split) <= 1.0 and split[1] <= 0.1, split
    assert max(once) > 1.5, once


@pytest.mark.cuda
def test_cuda_gradient_launches_the_backward_kernel(monkeypatch):
    """On a card, a gradient through ``ssd_scan`` launches the forward once
    and the backward kernel once, never the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    B, T, H, P, N, chunk = CASES[0]
    x, loga, Bm, C = (a.cuda() for a in _torch(*_inputs(5, B, T, H, P, N)))
    dy = torch.from_numpy(_cotangents(6, B, T, H, P, N)[0]).cuda()
    want = ssd_chunked_bwd_ref(x, loga, Bm, C, dy, None, chunk)

    def plain(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    monkeypatch.setattr(ssd_mod, "ssd_chunked_ref", plain)
    monkeypatch.setattr(ssd_mod, "ssd_chunked_bwd_ref", plain)
    fwd, bwd = ssd_scan.launches, ssd_scan_bwd.launches
    args = [a.requires_grad_() for a in (x, loga, Bm, C)]
    y, _ = ssd_scan(*args, chunk=chunk)
    got = torch.autograd.grad(y, args, dy)
    torch.cuda.synchronize()
    assert (ssd_scan.launches, ssd_scan_bwd.launches) == (fwd + 1, bwd + 1)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))
