"""The Mamba2 block's epilogue (repro_torch.kernels.mamba_gate): the D skip,
the SiLU gate and the RMSNorm between the SSD scan and the output
projection, one hand-written kernel forward and one backward on the card.

On the CPU (the wrapper runs the plain version, ``gated_rms_norm_ref``):

* the plain version's output and its gradients for y, xh, z, D and the
  norm's scale equal the expression the block computed before the kernel,
  bit for bit, in bfloat16 and float32, at 1, 5 and 16 rows of 64 and 2048
  channels; the CPU wrapper counts no launch;
* the gradient the kernel is held to (``gated_rms_norm_bwd_ref``: float64
  autograd at the point the plain version's forward reaches) equals plain
  float64 autograd where nothing rounds (float64 inputs);
* the kernel's arithmetic, transliterated to PyTorch: its forward (the
  rounding points) equals the plain version bit for bit; its backward (the
  forward's roundings recomputed, then dg = rstd (dx^ - x^ mean(dx^ x^)), du = dg s,
  dz = dg u silu'(z), dxh = du D, dD and dw summed over the rows) lies
  within the card's limit below of that gradient, while a control computed
  in bfloat16 throughout (the norm too) and the backward without the norm's
  projection term (x^ mean(dx^ x^)) lie outside it;
* ``launch_plan`` at the model shapes and what it rejects; the wrapper's
  checks on ``meta`` tensors (dtype, shape, contiguity); the C entry points'
  arity; every kernel name of the source classed as elementwise work by the
  benchmark's frozen ``bench/counts/kernel_classes.json``.

On the card (``cuda``; skip without one; ``chip_smoke.py``'s
``[mamba-gate-kernel]`` makes the same checks inline), at mamba2's training shape (8 x
4096 rows, H 32, P 64), a row wider than one pass (H 128, P 64) and ragged
small shapes (37 and 9 rows a batch, 5 and 3 heads of 16 and 8):

* the forward equals the plain version, or lies within a few units in the
  last place of the output type (bfloat16: 1; float32: 8, rsqrtf's and the
  two products' roundings) where the row's float32 sum of squares, summed
  in another order, moved rstd; the share of elements that differ is
  printed;
* the gradients against ``gated_rms_norm_bwd_ref`` (float64 at the plain
  forward's rounded point), each within a relative 2-norm distance set by
  its dtype (``GRAD_LIMIT``): a bfloat16 gradient 2^-8 (one rounding of each
  element reads about 2^-9.3, the kernel's only departure beside float32
  arithmetic), a float32 one 1e-4 (sums in another order); the bfloat16
  limit rejects the bfloat16-throughout control, and the eager bfloat16
  chain's own distance is printed beside it;
* two backward calls give the same bits (no atomics);
* the wrapper raises on a non-contiguous or misaligned input, on heads
  whose P takes no whole 16-byte vectors and on a dtype other than bfloat16
  and float32, and never runs the plain version on CUDA tensors;
* one mamba2-370m training step (48 layers, remat) launches the forward 96
  times (forward and recompute) and the backward 48 times.
"""
import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.kernels.mamba_gate import (gated_rms_norm, gated_rms_norm_bwd,  # noqa: E402
                                            gated_rms_norm_bwd_ref, gated_rms_norm_ref,
                                            launch_plan)
from repro_torch.kernels.mamba_gate import ops as gate_ops  # noqa: E402
from repro_torch.models.layers import rms_norm, silu  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "kernels" / "mamba_gate"

#: (B, S, H, P): 1, 5 and 16 rows of 64 and 2048 channels
CPU_SHAPES = [(1, 1, 4, 16), (1, 5, 4, 16), (2, 8, 4, 16),
              (1, 1, 32, 64), (1, 5, 32, 64), (2, 8, 32, 64)]
DTYPES = [torch.bfloat16, torch.float32]
#: mamba2's training shape, a row of 8192 channels (two passes of 512 x 8
#: bf16), and ragged small shapes (rows and heads; P a multiple of 8)
CARD_SHAPES = [(8, 4096, 32, 64), (1, 64, 128, 64), (3, 37, 5, 16), (2, 9, 3, 8)]
#: the gradients' limits against ``gated_rms_norm_bwd_ref``, by the gradient's
#: dtype: ||got - want||_2 <= limit ||want||_2.  A bfloat16 gradient rounded
#: once from float32 reads about 2^-9.3 (an element's rounding is uniform
#: within half a unit in the last place, 2^-8 of the element at most): 2^-8
#: leaves it twice that room, and rejects a backward that rounds every step
#: in bfloat16, the norm's included (1.2 to 1.7 times the limit on dy, dxh
#: and dz; 20 and more times on dD and dnorm).  A float32 gradient
#: (dD and dnorm always; all five from float32 inputs) differs by its sums'
#: order alone (1e-7 to 1e-6)
GRAD_LIMIT = {torch.bfloat16: 2.0 ** -8, torch.float32: 1e-4}
#: the forward's limit where the row's sum of squares, summed in another order
#: than PyTorch's reduction, moved its mean by an ulp or two: in units in the
#: last place of the output type.  bfloat16 rounds that away but at a
#: rounding boundary (1); in float32 rsqrtf (MUFU's approximation, within 2
#: ulp, not monotone in its last bits) can turn it into a few ulps of rstd,
#: and the two products add one each (8)
FWD_ULPS = {torch.bfloat16: 1, torch.float32: 8}


def _inputs(B, S, H, P, dtype, device="cpu", seed=0):
    """y, xh, z (in ``dtype``), D, norm (float32) and an output gradient."""
    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0, shift=0.0, dt=dtype):
        return torch.as_tensor(shift + scale * rng.standard_normal(shape),
                               dtype=torch.float32).to(device=device, dtype=dt)

    y, xh, z = t((B, S, H, P)), t((B, S, H, P), 0.5), t((B, S, H * P), 2.0)
    D = torch.as_tensor(rng.uniform(0.5, 1.5, H), dtype=torch.float32).to(device)
    norm = t((H * P,), 0.1, 1.0, torch.float32)
    dout = t((B, S, H * P))
    return y, xh, z, D, norm, dout


def _eager(y, xh, z, D, norm):
    """The block's epilogue as ``models/mamba2.py`` wrote it before the kernel."""
    B, S, h, pd = y.shape
    y = y + D[None, None, :, None].to(y.dtype) * xh
    y = y.reshape(B, S, h * pd)
    return rms_norm(y * silu(z), norm)


def _grads(fn, inputs, dout):
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        out = fn(*leaves)
        return (out, *torch.autograd.grad(out, leaves, dout))


def _bits_equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


# ---------------------------------------------------------------------------
# CPU: the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("shape", CPU_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_version_equals_the_eager_epilogue(shape, dtype):
    """Forward and every gradient bit for bit: the wrapper (plain version on
    the CPU) against the block's pre-kernel expression."""
    y, xh, z, D, norm, dout = _inputs(*shape, dtype, seed=sum(shape))
    got = _grads(gated_rms_norm, (y, xh, z, D, norm), dout)
    want = _grads(_eager, (y, xh, z, D, norm), dout)
    assert got[0].dtype == dtype and got[0].shape == z.shape
    for name, g, w in zip(("out", "dy", "dxh", "dz", "dD", "dnorm"), got, want):
        assert _bits_equal(g, w), name
    # the backward's CPU route is the same autograd
    for g, w in zip(gated_rms_norm_bwd(y, xh, z, D, norm, None, dout), want[1:]):
        assert _bits_equal(g, w)


def test_cpu_wrapper_counts_no_launch():
    y, xh, z, D, norm, dout = _inputs(2, 8, 4, 16, torch.bfloat16)
    fwd, bwd = gated_rms_norm.launches, gated_rms_norm_bwd.launches
    _grads(gated_rms_norm, (y, xh, z, D, norm), dout)
    gated_rms_norm_bwd(y, xh, z, D, norm, None, dout)
    assert (gated_rms_norm.launches, gated_rms_norm_bwd.launches) == (fwd, bwd)


# ---------------------------------------------------------------------------
# CPU: the kernel's arithmetic, transliterated
# ---------------------------------------------------------------------------

def _rnd(v: torch.Tensor, dtype) -> torch.Tensor:
    return v.to(dtype).float()


def _kernel_like(y, xh, z, D, norm, dout, projection: bool = True):
    """``csrc/gated_rms_norm.cu``'s arithmetic in float32 tensor operations:
    the forward's roundings in the inputs' dtype, rstd and the output, then
    the backward's gradients (dy, dxh, dz rounded once to the dtype; dD,
    dnorm float32): (out, (dy, dxh, dz, dD, dnorm)).  ``projection=False``
    drops the norm's projection term from dg (a fault the limit must catch)."""
    dt = y.dtype
    B, S, H, P = y.shape
    f = [t.float().reshape(B * S, H * P) for t in (y, xh, z, dout)]
    yv, xv, zv, dv = f
    Dh = _rnd(D, dt).repeat_interleave(P)[None, :]
    u = _rnd(yv + _rnd(Dh * xv, dt), dt)
    ef = torch.exp(-zv)
    r = _rnd(1.0 / _rnd(1.0 + _rnd(ef, dt), dt), dt)
    s = _rnd(zv * r, dt)
    g = _rnd(u * s, dt)
    rs = torch.rsqrt(torch.mean(g * g, dim=-1, keepdim=True) + gate_ops.EPS)
    xhat = g * rs
    out = (xhat * norm[None, :]).to(dt).reshape(z.shape)
    dxhat = dv * norm[None, :]
    mean = (dxhat * xhat).sum(-1, keepdim=True) / (H * P) if projection else 0.0
    dg = rs * (dxhat - xhat * mean)
    du, ds = dg * s, dg * u
    sig = 1.0 / (1.0 + ef)
    dz = ds * (sig * (1.0 + zv * (1.0 - sig)))
    dD = (du * xv).reshape(B * S, H, P).sum((0, 2))
    dnorm = (dv * xhat).sum(0)
    return out, (du.to(dt).reshape(y.shape), (du * Dh).to(dt).reshape(y.shape),
                 dz.to(dt).reshape(z.shape), dD, dnorm)


def _limit_excess(got, want) -> float:
    """||got - want||_2 over ``GRAD_LIMIT[got.dtype]`` ||want||_2."""
    g, w = got.double(), want.double()
    return float((g - w).norm()) / (GRAD_LIMIT[got.dtype] * float(w.norm()))


def _lowp(y, xh, z, D, norm):
    """The control: the epilogue in ``y``'s dtype throughout, the norm's
    mean, rsqrt and scale too (``rms_norm`` works in float32)."""
    B, S, H, P = y.shape
    u = (y + D[None, None, :, None].to(y.dtype) * xh).reshape(B, S, H * P)
    g = u * silu(z)
    return g * torch.rsqrt(torch.mean(g * g, -1, keepdim=True) + gate_ops.EPS) * \
        norm.to(y.dtype)


def test_float64_gradient_is_autograd_where_nothing_rounds():
    """On float64 inputs no step before the norm rounds:
    ``gated_rms_norm_bwd_ref`` is then autograd through the plain version,
    whose norm works in float32 (``rms_norm``'s upcast)."""
    y, xh, z, D, norm, dout = _inputs(2, 8, 4, 16, torch.float64)
    D, norm = D.double(), norm.double()
    got = gated_rms_norm_bwd_ref(y, xh, z, D, norm, dout)
    want = _grads(gated_rms_norm_ref, (y, xh, z, D, norm), dout)[1:]
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("shape", [(2, 8, 4, 16), (1, 5, 32, 64), (8, 16, 32, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_arithmetic_against_autograd(shape, dtype):
    """The transliterated forward equals the plain version bit for bit (the
    same rounding points; the CPU's own sum of squares), and the
    transliterated backward lies within ``GRAD_LIMIT`` of the float64
    gradient at the plain forward's point."""
    y, xh, z, D, norm, dout = _inputs(*shape, dtype, seed=7)
    out, got = _kernel_like(y, xh, z, D, norm, dout)
    assert _bits_equal(out, gated_rms_norm_ref(y, xh, z, D, norm))
    want = gated_rms_norm_bwd_ref(y, xh, z, D, norm, dout)
    for name, g, w in zip(("dy", "dxh", "dz", "dD", "dnorm"), got, want):
        assert g.shape == w.shape
        assert _limit_excess(g, w) <= 0.75, name


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("shape", [(3, 37, 5, 16), (8, 16, 32, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_gradient_limit_rejects_lower_precision_and_a_dropped_term(shape, dtype):
    """What the limit must reject: the backward without the norm's
    projection term (both dtypes), and in bfloat16 autograd through the
    epilogue computed in bfloat16 throughout."""
    y, xh, z, D, norm, dout = _inputs(*shape, dtype, seed=19)
    want = gated_rms_norm_bwd_ref(y, xh, z, D, norm, dout)
    fault = _kernel_like(y, xh, z, D, norm, dout, projection=False)[1]
    assert max(_limit_excess(g, w) for g, w in zip(fault, want)) > 4.0
    if dtype == torch.bfloat16:
        control = _grads(_lowp, (y, xh, z, D, norm), dout)[1:]
        assert max(_limit_excess(g, w) for g, w in zip(control, want)) > 1.2


# ---------------------------------------------------------------------------
# CPU: plan, checks, entry points, kernel names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("HP, P, dtype, want", [
    (2048, 64, torch.bfloat16, (8, 1, 256)),  # mamba2: 256 threads x 8 bf16
    (2048, 64, torch.float32, (4, 1, 512)),
    (8192, 64, torch.bfloat16, (8, 2, 512)),  # two passes over the row
    (16384, 64, torch.bfloat16, (8, 4, 512)),  # jamba-1.5-large's d_inner
    (128, 16, torch.float32, (4, 1, 32)),  # the SMOKE configs
    (60, 12, torch.float32, (4, 1, 32)),  # f32 vectors need P % 4 only
])
def test_launch_plan(HP, P, dtype, want):
    plan = launch_plan(HP, P, dtype)
    assert (plan.vec, plan.chunks, plan.threads) == want
    assert plan.threads % 32 == 0 and plan.threads * plan.chunks * plan.vec >= HP


@pytest.mark.parametrize("args, err", [
    ((2048, 64, torch.float16), TypeError),
    ((2050, 64, torch.bfloat16), ValueError),  # not a multiple of P
    ((60, 12, torch.bfloat16), ValueError),  # a bf16 vector would span two heads
    ((512 * 8 * 4 + 8, 8, torch.bfloat16), ValueError),  # wider than 4 passes
])
def test_launch_plan_rejects(args, err):
    with pytest.raises(err):
        launch_plan(*args)


def test_meta_tensors_are_checked_then_shaped():
    """On ``meta`` tensors (a dry run) the wrapper makes the kernel's checks
    and returns the plain version's shapes, gradient included."""
    y, xh, z, D, norm, dout = (t.to("meta") for t in _inputs(2, 8, 4, 16, torch.bfloat16))
    out = gated_rms_norm(y, xh, z, D, norm)
    assert out.device.type == "meta" and out.shape == z.shape and out.dtype == torch.bfloat16
    grads = gated_rms_norm_bwd(y, xh, z, D, norm, None, dout)
    assert [g.shape for g in grads] == [y.shape, xh.shape, z.shape, D.shape, norm.shape]
    with pytest.raises(TypeError):
        gated_rms_norm(y.half(), xh.half(), z.half(), D, norm)
    with pytest.raises(TypeError):
        gated_rms_norm(y, xh, z, D.bfloat16(), norm)
    with pytest.raises(ValueError):
        gated_rms_norm(y.transpose(0, 1), xh.transpose(0, 1),
                       z.transpose(0, 1), D, norm)  # (S, B, ...) views: not contiguous
    with pytest.raises(ValueError):
        gated_rms_norm(y, xh, z[..., :-1], D, norm)
    y12, xh12, z12, D12, norm12, _ = (t.to("meta") for t in _inputs(2, 8, 5, 12, torch.bfloat16))
    with pytest.raises(ValueError):  # P % 8: the kernel takes no such rows
        gated_rms_norm(y12, xh12, z12, D12, norm12)
    with pytest.raises(ValueError):
        gated_rms_norm(y, xh, z, D, torch.ones(norm.shape))  # on another device


def test_c_entry_points_match_their_argtypes():
    src = (SRC / "csrc" / "gated_rms_norm.cu").read_text()
    tree = ast.parse((SRC / "ops.py").read_text())
    argtypes = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if getattr(t, "attr", None) == "argtypes":
                    argtypes[t.value.attr] = len(node.value.elts)
    assert set(argtypes) == {"gated_rms_norm", "gated_rms_norm_bwd",
                             "gated_rms_norm_bwd_occupancy"}
    for name, n in argtypes.items():
        sig = re.search(rf'extern "C" int {name}\((.*?)\)\s*\{{', src, re.S).group(1)
        assert len([p for p in sig.split(",") if p.strip()]) == n, name


def test_kernel_names_are_classed_elementwise():
    """Each ``__global__`` name of the source, bare and as the profiler
    prints a template instance, falls in the benchmark's elementwise class
    (the first class whose pattern it matches), not in ``port`` or
    ``gemm``."""
    classes = json.loads((ROOT / "bench" / "counts" / "kernel_classes.json").read_text())
    src = (SRC / "csrc" / "gated_rms_norm.cu").read_text()
    names = re.findall(r"__global__ void(?: __launch_bounds__\(\w+\))?\s+(\w+)\(", src)
    assert sorted(names) == ["gated_rms_norm_bwd_kernel", "gated_rms_norm_bwd_sum_kernel",
                             "gated_rms_norm_fwd_kernel"]
    for name in names:
        for full in (name, f"void (anonymous namespace)::{name}<__nv_bfloat16, 8, 1>("
                           f"__nv_bfloat16 const*, float const*, float*, int, int, float)",
                     f"void (anonymous namespace)::{name}<float, 4, 2>(float const*, "
                     f"float*, int, int, float)"):
            cls = next(c for c, pattern in classes["classes"] if re.search(pattern, full))
            assert cls == "elementwise", full


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda", torch.cuda.current_device())


def _ordered(t: torch.Tensor) -> torch.Tensor:
    """Float bits as integers in the floats' order (for ulp distances)."""
    itype = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[t.dtype]
    mask = {torch.bfloat16: 0x7FFF, torch.float32: 0x7FFFFFFF}[t.dtype]
    i = t.contiguous().view(itype).long()
    return torch.where(i < 0, -(i & mask), i)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_card_forward_matches_the_plain_version(shape, dtype):
    device = _cuda()
    y, xh, z, D, norm, _ = _inputs(*shape, dtype, device, seed=11)
    before = gated_rms_norm.launches
    got = gated_rms_norm(y, xh, z, D, norm)
    want = gated_rms_norm_ref(y, xh, z, D, norm)
    torch.cuda.synchronize()
    assert gated_rms_norm.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    ulps = (_ordered(got) - _ordered(want)).abs()
    differ = float((ulps > 0).double().mean())
    rows = float((ulps.reshape(-1, ulps.shape[-1]) > 0).any(-1).double().mean())
    print(f"[mamba-gate] forward {shape} {str(dtype)[6:]}: plan "
          f"{launch_plan(shape[2] * shape[3], shape[3], dtype)}; {differ:.3e} of the elements "
          f"and {rows:.3e} of the rows differ from the plain version, by at most "
          f"{int(ulps.max())} ulp (limit {FWD_ULPS[dtype]})")
    assert int(ulps.max()) <= FWD_ULPS[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_card_gradients_match_the_float64_gradient(shape, dtype):
    device = _cuda()
    inputs = _inputs(*shape, dtype, device, seed=13)
    y, xh, z, D, norm, dout = inputs
    before = (gated_rms_norm.launches, gated_rms_norm_bwd.launches)
    got = _grads(gated_rms_norm, (y, xh, z, D, norm), dout)[1:]
    torch.cuda.synchronize()
    assert (gated_rms_norm.launches, gated_rms_norm_bwd.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    want = gated_rms_norm_bwd_ref(y, xh, z, D, norm, dout)
    eager = _grads(gated_rms_norm_ref, (y, xh, z, D, norm), dout)[1:]
    report = []
    for name, g, w, e in zip(("dy", "dxh", "dz", "dD", "dnorm"), got, want, eager):
        assert g.dtype == e.dtype and g.shape == w.shape, name
        ex, ex_eager = _limit_excess(g, w), _limit_excess(e, w)
        report.append(f"{name} {ex:.3f} (eager {ex_eager:.3f})")
        assert ex <= 1.0, (name, ex)
    if dtype == torch.bfloat16:
        control = _grads(_lowp, (y, xh, z, D, norm), dout)[1:]
        worst = max(_limit_excess(g, w) for g, w in zip(control, want))
        report.append(f"bfloat16-throughout control {worst:.3f}")
        assert worst > 1.0
    print(f"[mamba-gate] backward {shape} {str(dtype)[6:]}: relative 2-norm distance from the "
          f"float64 gradient over the limit: " + ", ".join(report))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_card_backward_is_deterministic(dtype):
    device = _cuda()
    y, xh, z, D, norm, dout = _inputs(*CARD_SHAPES[0], dtype, device, seed=17)
    _, rstd = gate_ops._forward(y, xh, z, D, norm, save_rstd=True)
    first = gated_rms_norm_bwd(y, xh, z, D, norm, rstd, dout)
    second = gated_rms_norm_bwd(y, xh, z, D, norm, rstd, dout)
    torch.cuda.synchronize()
    assert all(_bits_equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_card_wrapper_raises_and_never_falls_back(monkeypatch):
    device = _cuda()
    y, xh, z, D, norm, _ = _inputs(2, 8, 4, 16, torch.bfloat16, device)

    def plain(*a, **k):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(gate_ops, "gated_rms_norm_ref", plain)
    gated_rms_norm(y, xh, z, D, norm)
    with pytest.raises(ValueError, match="contiguous"):
        gated_rms_norm(y.transpose(0, 1), xh.transpose(0, 1), z.transpose(0, 1), D, norm)
    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            gated_rms_norm(y.to(dt), xh.to(dt), z.to(dt), D, norm)
    shifted = torch.empty(y.numel() + 1, dtype=y.dtype, device=device)[1:].view(y.shape)
    shifted.copy_(y)  # contiguous, 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        gated_rms_norm(shifted, xh, z, D, norm)
    y12, xh12, z12, D12, norm12, _ = _inputs(2, 8, 5, 12, torch.bfloat16, device)
    with pytest.raises(ValueError):
        gated_rms_norm(y12, xh12, z12, D12, norm12)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_card_training_step_launch_counts():
    """One mamba2-370m training step (48 Mamba layers, remat): 96 forward
    launches (forward and recompute) and 48 backward calls."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_lm, param_leaves
    from repro_torch.optim import make_optimizer
    from repro_torch.train.steps import TrainHParams, make_train_step

    device = _cuda()
    cfg = get_config("mamba2-370m")
    model = init_lm(cfg, device=device, dtype=cfg.param_dtype)
    opt = make_optimizer(cfg.optimizer)[0](param_leaves(model))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (1, 256)),
                             dtype=torch.int32, device=device)
    gated_rms_norm.launches = gated_rms_norm_bwd.launches = 0
    _, _, metrics = make_train_step(cfg, TrainHParams(warmup=1))(model, opt, {"tokens": tokens})
    torch.cuda.synchronize()
    assert np.isfinite(float(metrics["loss"]))
    n_mamba = sum(1 for _ in range(cfg.n_periods) for k in cfg.period if k == "mamba")
    assert n_mamba == 48
    assert (gated_rms_norm.launches, gated_rms_norm_bwd.launches) == (96, 48)
