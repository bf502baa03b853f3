"""Causal chunked attention visits only the key chunks a query chunk can see
(``repro_torch.models.layers._chunked_attention``).

On the CPU:

* the loop equals the loop over every (query chunk, key chunk) pair that it
  replaced (``_all_pairs``, copied here as it stood), bit for bit: the
  output and the gradients of q, k and v under a fixed upstream gradient,
  in bfloat16 and float32, for a sequence a multiple of the chunk, one that
  is not (the last key chunk padded), one shorter than a chunk, GQA and one
  query head a key head, causal and bidirectional self-attention, and
  causal and bidirectional cross-attention with fewer and more keys than
  queries (query and key chunks of different lengths among them);
* under an installed recorder a call adds its pairs to
  ``attention.chunk_pairs`` / ``_run`` / ``_masked``: 64 / 36 / 8 for a
  causal call over 8 x 8 chunks, 64 / 64 / 0 for a bidirectional one and
  64 / 64 / 8 where the last key chunk is padded; without one nothing is
  recorded; a training step counts each attention layer's forward and its
  remat recompute.

On the card (``cuda``; skip without one), at one attention layer of the two
training cells that run it (olmoe-1b-7b: 4 x 4096, 16 heads of 128;
granite-4.0-h-small: 4 x 4096, 32 query and 8 key heads of 128), bfloat16:
the output and gradients equal the every-pair loop's, and the device ms of a
forward and backward of each are printed.
"""
import dataclasses

import pytest
torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from repro_torch import runtime  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.cfa import obs  # noqa: E402
from repro_torch.models.layers import _chunked_attention  # noqa: E402
from repro_torch.train.loop import Trainer  # noqa: E402
from repro_torch.train.steps import TrainHParams  # noqa: E402


def _all_pairs(q, k, v, *, causal: bool, chunk: int, scale: float):
    """The loop as it stood before it skipped pairs: every (query chunk, key
    chunk) pair, each masked."""
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    cq, ck = min(chunk, Sq), min(chunk, Sk)
    nq, nk = -(-Sq // cq), -(-Sk // ck)
    qpad, kpad = nq * cq - Sq, nk * ck - Sk
    dev = q.device
    qf = F.pad(q, (0, 0, 0, 0, 0, qpad)).float()
    kf = F.pad(k, (0, 0, 0, 0, 0, kpad)).float()
    vf = F.pad(v, (0, 0, 0, 0, 0, kpad)).float()
    kv_heads = k.shape[2]
    g = H // kv_heads

    qf = qf.reshape(B, nq, cq, kv_heads, g, Dh).permute(1, 0, 3, 4, 2, 5)
    kf = kf.reshape(B, nk, ck, kv_heads, Dh).permute(1, 0, 3, 2, 4)
    vf = vf.reshape(B, nk, ck, kv_heads, Dh).permute(1, 0, 3, 2, 4)

    q_pos = torch.arange(nq * cq, device=dev).reshape(nq, cq)
    k_pos = torch.arange(nk * ck, device=dev).reshape(nk, ck)
    k_valid = k_pos < Sk

    outs = []
    for i in range(nq):
        qc, qp = qf[i], q_pos[i]
        m = torch.full((B, kv_heads, g, cq), float("-inf"), device=dev)
        l = torch.zeros((B, kv_heads, g, cq), device=dev)
        acc = torch.zeros((B, kv_heads, g, cq, Dh), device=dev)
        for j in range(nk):
            kc, vc, kp, kval = kf[j], vf[j], k_pos[j], k_valid[j]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc) * scale
            mask = kval[None, None, None, None, :]
            if causal:
                mask = mask & (qp[None, None, None, :, None] >= kp[None, None, None, None, :])
            s = torch.where(mask, s, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            pexp = torch.exp(s - m_safe[..., None])
            pexp = torch.where(mask, pexp, 0.0)
            l = l * alpha + pexp.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", pexp, vc)
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, nq * cq, H, Dh)
    return out[:, :Sq].to(q.dtype)


def _inputs(B, Sq, Sk, H, kvh, Dh, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=device).to(dtype).requires_grad_()

    q, k, v = draw(B, Sq, H, Dh), draw(B, Sk, kvh, Dh), draw(B, Sk, kvh, Dh)
    dy = torch.randn((B, Sq, H, Dh), generator=g, device=device).to(dtype)
    return q, k, v, dy


def _run(fn, q, k, v, dy, **kw):
    out = fn(q, k, v, **kw)
    grads = torch.autograd.grad(out, (q, k, v), dy)
    return (out.detach(), *grads)


# (Sq, Sk, H, kv heads, chunk, causal); Sq != Sk: cross-attention
CASES = {
    "causal-8x8": (64, 64, 4, 4, 8, True),
    "causal-gqa": (64, 64, 8, 2, 16, True),
    "causal-padded": (53, 53, 4, 4, 16, True),
    "causal-padded-gqa": (45, 45, 4, 2, 16, True),
    "causal-one-chunk": (10, 10, 4, 2, 16, True),
    "self-8x8": (64, 64, 4, 4, 8, False),
    "self-padded-gqa": (53, 53, 8, 2, 16, False),
    "cross-causal-fewer-keys": (64, 40, 4, 2, 16, True),
    "cross-causal-more-keys": (40, 64, 4, 4, 16, True),
    "cross-causal-short-queries": (10, 50, 4, 2, 16, True),
    "cross-causal-short-keys": (50, 12, 4, 4, 16, True),
    "cross-fewer-keys": (64, 40, 4, 2, 16, False),
    "cross-more-keys": (40, 64, 8, 2, 16, False),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_equals_the_loop_over_every_pair_bit_for_bit(case, dtype):
    Sq, Sk, H, kvh, chunk, causal = CASES[case]
    q, k, v, dy = _inputs(2, Sq, Sk, H, kvh, 16, dtype, "cpu")
    kw = dict(causal=causal, chunk=chunk, scale=16 ** -0.5)
    got = _run(_chunked_attention, q, k, v, dy, **kw)
    want = _run(_all_pairs, q, k, v, dy, **kw)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype == dtype
        assert torch.equal(a, b), name


@pytest.mark.parametrize("S, causal, want", [
    (64, True, (64, 36, 8)),  # the cells' 8 x 8 geometry: 28 pairs skipped, 28 unmasked
    (64, False, (64, 64, 0)),
    (60, True, (64, 36, 8)),  # the padded last key chunk is a diagonal one
    (60, False, (64, 64, 8)),
])
def test_counters_count_the_pairs_of_a_call(S, causal, want):
    q, k, v, _ = _inputs(1, S, S, 2, 2, 8, torch.float32, "cpu")
    rec = obs.TraceRecorder()
    _chunked_attention(q, k, v, causal=causal, chunk=8, scale=1.0)  # none installed
    assert rec.counters.as_dict() == {}
    with torch.no_grad(), rec.installed():
        _chunked_attention(q, k, v, causal=causal, chunk=8, scale=1.0)
    assert runtime.active() is None
    c = rec.counters
    got = tuple(c[f"attention.chunk_pairs{s}"] for s in ("", "_run", "_masked"))
    assert got == want
    assert all(isinstance(n, int) for n in got)


def test_a_training_step_counts_each_layer_forward_and_recompute(tmp_path):
    cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"), n_layers=2)
    rec = obs.TraceRecorder()
    tr = Trainer(cfg, batch=2, seq=16, ckpt_dir=tmp_path, hp=TrainHParams(), device="cpu",
                 recorder=rec)
    try:
        tr.run(2, log_every=1)
    finally:
        tr.data.close()
    # 2 steps x 2 layers x (forward, recompute), one 16-token chunk pair a call
    c = rec.counters
    assert (c["attention.chunk_pairs"], c["attention.chunk_pairs_run"],
            c["attention.chunk_pairs_masked"]) == (8, 8, 8)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

# (name, B, S, query heads, key heads, head dim): one attention layer of a cell
CARD_SHAPES = [("olmoe-1b-7b", 4, 4096, 16, 16, 128),
               ("granite-4.0-h-small", 4, 4096, 32, 8, 128)]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells' shapes run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


def _device_ms(fn, args, iters=3):
    """Device ms of a forward and backward, by CUDA events over ``iters``
    calls after one warm call."""
    _run(fn, *args[0], **args[1])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        _run(fn, *args[0], **args[1])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@pytest.mark.cuda
@pytest.mark.parametrize("name, B, S, H, kvh, Dh", CARD_SHAPES, ids=[s[0] for s in CARD_SHAPES])
def test_on_the_card_at_a_cell_s_layer(name, B, S, H, kvh, Dh):
    device = _cuda()
    q, k, v, dy = _inputs(B, S, S, H, kvh, Dh, torch.bfloat16, device, seed=31)
    kw = dict(causal=True, chunk=512, scale=Dh ** -0.5)
    got = _run(_chunked_attention, q, k, v, dy, **kw)
    want = _run(_all_pairs, q, k, v, dy, **kw)
    for label, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert torch.equal(a, b), label
    del got, want
    rec = obs.TraceRecorder()
    with torch.no_grad(), rec.installed():
        _chunked_attention(q, k, v, **kw)
    assert [rec.counters[f"attention.chunk_pairs{s}"] for s in ("", "_run", "_masked")] == \
        [64, 36, 8]
    args = ((q, k, v, dy), kw)
    ms = {"skip": _device_ms(_chunked_attention, args), "all_pairs": _device_ms(_all_pairs, args)}
    print(f"\n[attention-chunks] {name} B {B} S {S} H {H}/{kvh} Dh {Dh} bf16 "
          f"{torch.cuda.get_device_name(device)}: forward+backward device ms "
          f"skip {ms['skip']:.3f} all_pairs {ms['all_pairs']:.3f} "
          f"({ms['skip'] / ms['all_pairs']:.3f}x)")
