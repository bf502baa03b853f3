"""The port's facet-layout decode attention (repro_torch.kernels.block_attention)
on CPU tensors, where the wrapper runs the kernel's plain PyTorch version.

The CUDA kernel itself is held against this plain version on the card by
``chip_smoke.py``.  Here, on inputs drawn with ``numpy.random.default_rng``
and handed to both packages:

* the plain path against the reference's Pallas kernel (``interpret=True``)
  and its ``decode_attention_ref`` on ``tests/test_kernels.py``'s cases and
  the partial final block, in float32 (tolerance 2e-5) and bfloat16 (3e-2,
  the reference's own);
* ``blockify``/``deblockify``/``append_token`` bit for bit;
* the kernel's plan (split-K over fixed ranges of each block, splits past
  the length exiting, staged sub-tiles of the valid rows only, online
  softmax with the all -inf guard, the partials merged in split order),
  transliterated to numpy from ``csrc/block_attention.cu``, against the
  plain version, and the host's launch plan (grid from the static shape,
  shared memory for several CTAs per SM);
* the rejections, the launch counter and the C entry point's arity.
"""
import ast
import math
import re
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax  # noqa: F401  (both frameworks in one process)
import jax.numpy as jnp

from repro.kernels.block_attention import append_token as jax_append
from repro.kernels.block_attention import blockify as jax_blockify
from repro.kernels.block_attention import deblockify as jax_deblockify
from repro.kernels.block_attention import decode_attention as jax_decode
from repro.kernels.block_attention import decode_attention_ref as jax_decode_ref
from repro_torch.kernels.block_attention import (
    append_token,
    blockify,
    deblockify,
    decode_attention,
    decode_attention_ref,
)
from repro_torch.kernels.block_attention import block_attention as attn_mod

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"

CASES = [  # tests/test_kernels.py's cases: B, Hq, Hkv, D, S, bs
    (2, 8, 2, 64, 256, 64),
    (1, 4, 4, 32, 128, 32),   # MHA (no grouping)
    (3, 16, 1, 64, 192, 64),  # MQA
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


@pytest.fixture(autouse=True)
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)  # torch's default


def _inputs(seed, B, Hq, Hkv, D, S, lengths=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    kc = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    vc = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    if lengths is None:
        lengths = rng.integers(1, S + 1, size=(B,))
    return q, kc, vc, np.asarray(lengths, np.int32)


def _both(arrays, dtype):
    """The same numpy arrays as JAX and torch tensors of one dtype (both
    round float32 to bfloat16 to nearest even)."""
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,Hq,Hkv,D,S,bs", CASES)
def test_plain_version_matches_reference_kernel_and_ref(B, Hq, Hkv, D, S, bs, dtype):
    q, kc, vc, lengths = _inputs(7, B, Hq, Hkv, D, S)
    (jq, jk, jv), (tq, tk, tv) = _both((q, kc, vc), dtype)
    tol = DTYPES[dtype][2]
    got = decode_attention(tq, blockify(tk, bs), blockify(tv, bs), torch.from_numpy(lengths))
    assert got.dtype == tq.dtype and got.shape == (B, Hq, D)
    want = jax_decode(jq, jax_blockify(jk, bs), jax_blockify(jv, bs), jnp.asarray(lengths))
    _close(got, want, tol)
    _close(got, jax_decode_ref(jq, jk, jv, jnp.asarray(lengths)), tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_partial_final_block(dtype):
    """Lengths that do not align with block boundaries mask correctly."""
    B, Hq, Hkv, D, S, bs = 2, 4, 2, 32, 128, 32
    q, kc, vc, lengths = _inputs(3, B, Hq, Hkv, D, S, lengths=[1, 33])
    (jq, jk, jv), (tq, tk, tv) = _both((q, kc, vc), dtype)
    got = decode_attention(tq, blockify(tk, bs), blockify(tv, bs), torch.from_numpy(lengths))
    want = jax_decode(jq, jax_blockify(jk, bs), jax_blockify(jv, bs), jnp.asarray(lengths))
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ref_matches_reference_ref_over_the_canonical_cache(dtype):
    q, kc, vc, lengths = _inputs(5, 2, 6, 3, 16, 40, lengths=[40, 17])
    (jq, jk, jv), (tq, tk, tv) = _both((q, kc, vc), dtype)
    got = decode_attention_ref(tq, tk, tv, torch.from_numpy(lengths))
    _close(got, jax_decode_ref(jq, jk, jv, jnp.asarray(lengths)), DTYPES[dtype][2])


def test_mixed_precision_query_over_a_bf16_cache():
    """The model's pairing under float32 compute: a float32 query over the
    bfloat16 cache; the output keeps the query's dtype."""
    q, kc, vc, lengths = _inputs(9, 2, 4, 2, 32, 64)
    kb = torch.from_numpy(kc).to(torch.bfloat16)
    vb = torch.from_numpy(vc).to(torch.bfloat16)
    got = decode_attention(torch.from_numpy(q), blockify(kb, 16), blockify(vb, 16),
                           torch.from_numpy(lengths))
    assert got.dtype == torch.float32
    want = jax_decode(jnp.asarray(q), jax_blockify(jnp.asarray(kc, jnp.bfloat16), 16),
                      jax_blockify(jnp.asarray(vc, jnp.bfloat16), 16), jnp.asarray(lengths))
    _close(got, want, 2e-5)


def test_blockify_roundtrip_and_append_are_bit_exact():
    rng = np.random.default_rng(11)
    B, S, H, D, bs = 2, 64, 4, 16, 16
    kc = rng.normal(size=(B, S, H, D)).astype(np.float32)
    blocks = blockify(torch.from_numpy(kc), bs)
    assert blocks.is_contiguous()
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(jax_blockify(jnp.asarray(kc), bs)))
    np.testing.assert_array_equal(deblockify(blocks).numpy(), kc)
    np.testing.assert_array_equal(
        deblockify(blocks).numpy(), np.asarray(jax_deblockify(jax_blockify(jnp.asarray(kc), bs))))
    k_new = rng.normal(size=(B, H, D)).astype(np.float32)
    want, _ = jax_append(jax_blockify(jnp.asarray(kc), bs), jax_blockify(jnp.asarray(kc), bs),
                         jnp.asarray(k_new), jnp.asarray(k_new), jnp.int32(37))
    kb, vb = blocks.clone(), blocks.clone()
    out_k, out_v = append_token(kb, vb, torch.from_numpy(k_new), torch.from_numpy(k_new), 37)
    assert out_k is kb and out_v is vb  # in place
    np.testing.assert_array_equal(kb.numpy(), np.asarray(want))
    np.testing.assert_array_equal(vb.numpy(), np.asarray(want))
    back = deblockify(kb)
    np.testing.assert_array_equal(back[:, 37].numpy(), k_new)
    np.testing.assert_array_equal(back[:, :37].numpy(), kc[:, :37])


def test_append_per_lane_positions_equal_one_append_per_row():
    rng = np.random.default_rng(12)
    B, S, H, D, bs = 3, 48, 2, 8, 16
    blocks = blockify(torch.from_numpy(rng.normal(size=(B, S, H, D)).astype(np.float32)), bs)
    new = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32))
    pos = [0, 17, 47]
    lanes = blocks.clone()
    append_token(lanes, lanes.clone(), new, new, torch.tensor(pos))
    for b, p in enumerate(pos):
        row = blocks[b:b + 1].clone()
        append_token(row, row.clone(), new[b:b + 1], new[b:b + 1], p)
        assert torch.equal(lanes[b:b + 1], row)


def test_append_past_the_capacity_raises():
    blocks = torch.zeros((2, 2, 1, 4, 3))
    new = torch.ones((2, 1, 3))
    with pytest.raises(IndexError, match="outside the cache's 8 slots"):
        append_token(blocks, blocks.clone(), new, new, 8)
    with pytest.raises(IndexError, match="outside"):
        append_token(blocks, blocks.clone(), new, new, torch.tensor([3, -1]))
    with pytest.raises(ValueError, match="scalar or"):
        append_token(blocks, blocks.clone(), new, new, torch.tensor([1, 2, 3]))


def _kernel_walk(q, k_blocks, v_blocks, lengths):
    """numpy transliteration of csrc/block_attention.cu at the wrapper's
    launch plan: per (row, kv head) the splits that start below the length
    (at least split 0), each over the valid rows of its range in staged
    sub-tiles with online softmax and the all -inf guard, giving a partial
    (m, l, acc); one split writes acc / l, several are merged in split
    order with weights exp(m_s - max m)."""
    B, nb, Hkv, bs, D = k_blocks.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    plan = attn_mod.launch_plan(B, Hq, Hkv, nb, bs, D, k_blocks.dtype.itemsize)
    assert plan.grid == (nb * plan.nspb, Hkv, B)
    scale = np.float32(math.sqrt(D))
    out = np.zeros((B, Hq, D), np.float32)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        for b in range(B):
            L = max(0, min(int(lengths[b]), nb * bs))
            n_work = plan.n_work(L)
            for h in range(Hkv):
                qs = q[b, h * G:(h + 1) * G].astype(np.float32)
                parts = []
                for s in range(n_work):  # CTAs s >= n_work exit at once
                    blk, r0 = s // plan.nspb, s % plan.nspb * plan.split
                    n_valid = max(0, min(plan.split, bs - r0, L - (blk * bs + r0)))
                    m = np.full(G, -np.inf, np.float32)
                    l = np.zeros(G, np.float32)
                    acc = np.zeros((G, D), np.float32)
                    for i0 in range(0, n_valid, plan.sub):  # staged rows below the length only
                        rows = r0 + i0 + np.arange(min(plan.sub, n_valid - i0))
                        keys = k_blocks[b, blk, h, rows].astype(np.float32)
                        vals = v_blocks[b, blk, h, rows].astype(np.float32)
                        sc = qs @ keys.T / scale
                        m_new = np.maximum(m, sc.max(axis=1))
                        fin = np.isfinite(m_new)
                        p = np.where(fin[:, None], np.exp(sc - m_new[:, None]), 0.0)
                        alpha = np.where(fin, np.exp(m - m_new), 1.0)
                        l = l * alpha + p.sum(axis=1)
                        acc = acc * alpha[:, None] + p @ vals
                        m = m_new
                    parts.append((m, l, acc))
                if len(parts) == 1:
                    m, l, acc = parts[0]
                    res = acc / l[:, None]
                else:
                    mx = np.max([pm for pm, _, _ in parts], axis=0)
                    fin = np.isfinite(mx)
                    lsum, num = np.zeros(G, np.float32), np.zeros((G, D), np.float32)
                    for pm, pl, pa in parts:  # split order
                        w = np.where(fin, np.exp(pm - mx), 0.0).astype(np.float32)
                        lsum = lsum + w * pl
                        num = num + w[:, None] * pa
                    res = num / lsum[:, None]
                out[b, h * G:(h + 1) * G] = res
    return out


@pytest.mark.parametrize("B,Hq,Hkv,D,bs,lengths", [
    (4, 8, 4, 32, 16, [1, 64, 65, 130]),      # splits of whole 16-row blocks
    (4, 8, 4, 32, 48, [47, 48, 49, 192]),     # lengths at block boundaries +-1
    (4, 8, 4, 32, 256, [1, 256, 257, 512]),   # qwen3's block size: two splits per block
    (8, 16, 8, 128, 256, [1, 127, 128, 129, 255, 256, 257, 512]),  # qwen3, 2 blocks deep
    (3, 8, 2, 32, 512, [1, 383, 1024]),       # splits wholly past the length exit
    (2, 16, 1, 64, 64, [5, 200]),             # G = 16 (MQA)
    (3, 4, 2, 256, 32, [1, 33, 96]),          # D = 256: 16-row sub-tiles in float32
    (2, 4, 2, 16, 32, [0, 40]),               # an empty row: 0/0 like the plain version
])
def test_the_kernels_walk_matches_the_plain_version(B, Hq, Hkv, D, bs, lengths):
    S = max(max(lengths), 1) + (-max(max(lengths), 1)) % bs
    q, kc, vc, lengths = _inputs(21, B, Hq, Hkv, D, S, lengths=lengths)
    kb, vb = blockify(torch.from_numpy(kc), bs), blockify(torch.from_numpy(vc), bs)
    want = decode_attention(torch.from_numpy(q), kb, vb, torch.from_numpy(lengths))
    got = _kernel_walk(q, kb.numpy(), vb.numpy(), lengths)
    np.testing.assert_allclose(got, want.numpy(), rtol=2e-5, atol=2e-5)


def test_launch_plan_at_the_qwen3_decode_tick():
    """The grid follows from the static shape alone; a CTA's ring and
    accumulators leave room for three per SM (228 KB), and the splits that
    work follow the lengths."""
    plan = attn_mod.launch_plan(8, 16, 8, 8, 256, 128, 2)
    assert plan.grid == (16, 8, 8) and (plan.split, plan.nspb, plan.sub) == (128, 2, 64)
    assert plan.bulk and plan.smem == 4 * 64 * 128 * 2 + 4 * (2 * 2 * 128 + 2 * 64 + 6)
    assert 3 * (plan.smem + 1024) <= 233472
    lengths = [1, 128, 129, 256, 257, 2048, 0, 5000]
    assert [plan.n_work(n) for n in lengths] == [1, 1, 2, 2, 3, 16, 1, 16]
    assert plan.working(lengths) == 8 * 42
    # float32 K/V at D 256: 16-row sub-tiles keep a stage at 16 KiB
    assert attn_mod.launch_plan(1, 16, 1, 1, 64, 256, 4).sub == 16
    assert not attn_mod.launch_plan(1, 2, 1, 1, 64, 33, 4).bulk  # 132-byte rows: word loads


def test_plain_version_is_the_wrapper_on_cpu_and_does_not_count():
    q, kc, vc, lengths = _inputs(1, 2, 4, 2, 16, 32)
    args = (torch.from_numpy(q), blockify(torch.from_numpy(kc), 8),
            blockify(torch.from_numpy(vc), 8), torch.from_numpy(lengths))
    before = [a.clone() for a in args]
    decode_attention.launches = 0
    got = decode_attention(*args)
    assert decode_attention.launches == 0
    assert torch.equal(got, decode_attention_ref(args[0], torch.from_numpy(kc),
                                                 torch.from_numpy(vc), args[3]))
    assert all(torch.equal(a, b) for a, b in zip(args, before))  # read only


def test_rejects_what_the_kernel_does_not_take():
    q = torch.zeros((2, 6, 8))
    k = torch.zeros((2, 1, 4, 4, 8))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        decode_attention(q, k, k, torch.ones(2, dtype=torch.int32))
    q = torch.zeros((2, 8, 8))
    with pytest.raises(ValueError, match="lengths must be"):
        decode_attention(q, k, k, torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="does not match the cache"):
        decode_attention(torch.zeros((2, 8, 4)), k, k, torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"want q \(B,Hq,D\)"):
        decode_attention(q, k, k[:, :, :2], torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA device, the CPU or meta"):
        decode_attention(q.as_subclass(_Elsewhere), k.as_subclass(_Elsewhere),
                         k.as_subclass(_Elsewhere), torch.ones(2))


class _Elsewhere(torch.Tensor):
    """A tensor that reports a device the wrapper does not take."""

    @property
    def device(self):
        return torch.device("xpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_tensors_propagate_the_shapes_of_the_cpu_output(dtype):
    """A dry run's ``meta`` tensors: the kernel's checks, then the plain
    version's shape and dtype; nothing launches."""
    q, kc, vc, lengths = _inputs(2, 3, 8, 2, 16, 40)
    kb = blockify(torch.from_numpy(kc).to(dtype), 8)
    vb = blockify(torch.from_numpy(vc).to(dtype), 8)
    qt = torch.from_numpy(q).to(dtype)
    lt = torch.as_tensor(lengths, dtype=torch.int32)
    decode_attention.launches = 0
    want = decode_attention(qt, kb, vb, lt)
    got = decode_attention(qt.to("meta"), kb.to("meta"), vb.to("meta"), lt.to("meta"))
    assert decode_attention.launches == 0
    assert got.device.type == "meta" and (got.shape, got.dtype) == (want.shape, want.dtype)
    with pytest.raises(TypeError, match="the kernel takes"):  # its own checks run on meta
        decode_attention(qt.to("meta", torch.float64), kb.to("meta"), vb.to("meta"),
                         lt.to("meta"))


def test_a_dtensor_raises():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    q = torch.zeros((2, 8, 8))
    k = torch.zeros((2, 1, 4, 4, 8))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        with pytest.raises(TypeError, match="not DTensors"):
            decode_attention(distribute_tensor(q, mesh), k, k, torch.ones(2, dtype=torch.int32))
    finally:
        dist.destroy_process_group()


def test_c_entry_point_matches_the_ctypes_binding():
    """The wrapper's argtypes and the .cu entry point agree in arity."""
    src = (SRC / "block_attention" / "csrc" / "block_attention.cu").read_text()
    sig = re.search(r'extern "C" int decode_attention\((.*?)\)\s*\{', src, re.S).group(1)
    n_params = len([p for p in sig.split(",") if p.strip()])
    tree = ast.parse((SRC / "block_attention" / "block_attention.py").read_text())
    argtypes = next(node.value for node in ast.walk(tree)
                    if isinstance(node, ast.Assign)
                    and any(getattr(t, "attr", None) == "argtypes" for t in node.targets))
    assert len(argtypes.elts) == n_params == 20


@pytest.mark.cuda
def test_cuda_tensors_launch_the_kernel_never_the_plain_version(monkeypatch):
    """On a card the wrapper launches the kernel (and counts it); the plain
    version is never its way out."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    q, kc, vc, lengths = _inputs(7, *CASES[0][:5])
    bs = CASES[0][5]
    args = (torch.from_numpy(q).cuda(), blockify(torch.from_numpy(kc), bs).cuda(),
            blockify(torch.from_numpy(vc), bs).cuda(), torch.from_numpy(lengths).cuda())
    want = decode_attention_ref(args[0], torch.from_numpy(kc).cuda(),
                                torch.from_numpy(vc).cuda(), args[3])

    def plain(*a, **k):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(attn_mod, "decode_attention_ref", plain)
    before = decode_attention.launches
    got = decode_attention(*args)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
