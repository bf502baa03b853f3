"""granite-4.0-h-small in the port (a hybrid Mamba-2 + MoE period with a
held share of the experts, a shared expert, NoPE attention, muP multipliers,
a tied head and conv biases) against the benchmark's plain float32
reference (``bench/reference/granite.py``, found through
``bench.registry``), on the CPU at the ``SMOKE`` widths.  Nothing here
imports JAX; the reference imports nothing of the port.

* the forward loss, the first step's gradient of every leaf and the
  parameters' change over three AdamW steps match the reference in float32
  compute, and the reference computing in float8 (the control) fails one
  of the same tolerances;
* a MoE layer's held shares, one per rank of the expert-parallel group,
  sum to the uncut layer (the shared expert and the aux loss counted once),
  in the port and in the reference;
* NoPE attention sees positions only through causality; each of the muP
  multipliers, the score scale, NoPE and the conv bias moves the
  reference's loss and gradients by far more than the match's tolerance
  (so a port that left one out would fail the match), and the tied head
  reads the table;
* at the new fields' defaults every existing configuration keeps its
  leaves, its operations and its outputs;
* ``lm_prefill`` followed by ``lm_decode`` gives the full forward's logits;
* the ``moe.*`` counters and the ``moe.shared`` span under a recorder.
"""
import dataclasses
import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config  # noqa: E402
from repro_torch.core.cfa import obs  # noqa: E402
from repro_torch.models import moe as tm  # noqa: E402
from repro_torch.models.layers import Attention, attention, mlp  # noqa: E402
from repro_torch.models.lm import (init_lm, lm_decode, lm_forward, lm_prefill,  # noqa: E402
                                   param_leaves)
from repro_torch.train.steps import TrainHParams, loss_fn  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from bench import inputs, registry  # noqa: E402

REF = registry.reference("granite")
LM_REF = registry.reference("lm")
NAME = "granite-4.0-h-small"
SEED = 2 ** 31 + 3030
#: float32 on both sides: the port's chunked attention, SSD kernel (plain
#: version) and capacity dispatch against the reference's full softmax,
#: chunked SSD matrices and gathered experts sum in other orders; the
#: readings lie at 1e-7 (loss) and 1e-6 (gradients, updates), so 1e-5 and
#: 1e-4 leave ten times that and sit under the float8 control by 100x
LOSS_TOL, GRAD_TOL, UPDATE_TOL = 1e-5, 1e-4, 1e-4


@pytest.fixture(autouse=True)
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)  # torch's default


@pytest.fixture(autouse=True)
def one_thread():
    """The SMOKE tensors are tiny: one thread runs them fastest, and a test
    run's parallel workers do not contend for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(**kw):
    """SMOKE in float32 compute, 4 of its 8 experts held."""
    return dataclasses.replace(get_smoke_config(NAME), compute_dtype="float32",
                               moe_experts_held=4, **kw)


def _arch(cfg) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(cfg).items()}


def _weights(cfg, seed=SEED) -> dict:
    """The reference's leaves, the conv biases drawn (not zeros) so that
    they count."""
    specs = [(k, s, "normal" if i == "zeros" else i, 0.5 if i == "zeros" else c)
             for k, s, i, c in REF.leaf_specs(_arch(cfg))]
    return inputs.weights(specs, seed, "cpu")


def _tokens(cfg, b=2, s=32, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s)))


def _port(cfg, w: dict, dtype="float32"):
    model = init_lm(cfg, device="cpu", dtype=dtype)
    leaves = {"/".join(leaf.path): leaf for leaf in param_leaves(model)}
    assert set(leaves) == set(w)
    for key, leaf in leaves.items():
        leaf.assign(w[key])
    return model


def _port_loss_grads(cfg, w, toks):
    model = _port(cfg, w)
    loss, _ = loss_fn(model, {"tokens": toks}, cfg, TrainHParams())
    loss.backward()
    return float(loss.detach()), {"/".join(leaf.path): leaf.take_grad()
                                  for leaf in param_leaves(model)}


def _ref_loss_grads(arch, w, toks, precision="float32"):
    params = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    model = REF.Model(arch, params, LM_REF._rounder(precision))
    fracs = model.first_fractions(toks, toks.shape[0])
    ce, aux = model.block_loss(toks, toks.numel(), toks.shape[0] * (toks.shape[1] - 1), fracs)
    loss = ce + TrainHParams().aux_coef * aux
    loss.backward()
    return float(loss.detach()), {k: v.grad for k, v in params.items()}


def _gaps(a, b) -> tuple[float, float]:
    """(relative loss gap, the worst leaf's relative gradient gap)."""
    (la, ga), (lb, gb) = a, b
    worst = max(float(torch.linalg.vector_norm(ga[k] - gb[k])
                      / torch.linalg.vector_norm(gb[k]).clamp_min(1e-12)) for k in gb)
    return abs(la - lb) / abs(lb), worst


def test_the_loss_and_every_leaf_s_gradient_match_the_reference():
    cfg = _cfg()
    w, toks = _weights(cfg), _tokens(cfg)
    loss_gap, grad_gap = _gaps(_port_loss_grads(cfg, w, toks), _ref_loss_grads(_arch(cfg), w, toks))
    assert loss_gap < LOSS_TOL and grad_gap < GRAD_TOL, (loss_gap, grad_gap)


def test_the_float8_control_fails_the_gradient_tolerance():
    cfg = _cfg()
    w, toks = _weights(cfg), _tokens(cfg)
    ref = _ref_loss_grads(_arch(cfg), w, toks)
    loss_gap, grad_gap = _gaps(_ref_loss_grads(_arch(cfg), w, toks, "float8"), ref)
    assert loss_gap > LOSS_TOL or grad_gap > GRAD_TOL, (loss_gap, grad_gap)
    assert grad_gap > 100 * GRAD_TOL


def _three_steps(tmp_path, precision=None):
    """The benchmark's readings of three AdamW steps at 4 x 32 tokens: the
    port's (``precision`` None) or the reference's."""
    from bench.drivers import train

    cfg = _cfg()
    config = {"name": "granite-smoke", "reference": "granite", "reference_rows": 2, "batch": 4,
              "arch": _arch(cfg), "hparams": dataclasses.asdict(TrainHParams()),
              "adamw": {"b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1}}
    mix = {"seq": 32, "check_steps": 3}
    if precision is not None:
        return train.reference_readings(config, mix, SEED, "cpu", precision=precision)
    trainer = train.make_trainer(config, mix, SEED, "cpu", tmp_path)
    try:
        return train.program_readings(trainer, config, mix, SEED)[0]
    finally:
        trainer.data.close()


def test_three_adamw_steps_match_the_reference_and_the_control_does_not(tmp_path):
    from bench.drivers import train

    ref = _three_steps(tmp_path, "float32")
    prog = train.gaps(_three_steps(tmp_path), ref)
    assert prog["loss_gap"] < LOSS_TOL and prog["first_grad_gap"] < GRAD_TOL \
        and prog["update_gap"] < UPDATE_TOL, prog
    ctl = train.gaps(_three_steps(tmp_path, "float8"), ref)
    assert ctl["first_grad_gap"] > GRAD_TOL and ctl["update_gap"] > UPDATE_TOL, ctl


# ---------------------------------------------------------------------------
# the held share
# ---------------------------------------------------------------------------

RANKS = 4  # 2 experts of 8 a rank


def test_the_port_s_held_shares_sum_to_the_uncut_layer():
    whole = dataclasses.replace(get_smoke_config(NAME), compute_dtype="float32",
                                moe_capacity_factor=0.5)  # drops: the capacity must be the layer's
    g = torch.Generator().manual_seed(7)
    full = tm.init_moe(whole, generator=g, device="cpu", dtype=torch.float32)
    x = torch.randn(2, 40, whole.d_model, generator=g)
    want, want_aux = tm.moe(full, x)
    shared = mlp(full.shared, x)
    held = whole.moe_experts // RANKS
    part = dataclasses.replace(whole, moe_experts_held=held)
    got = shared
    for r in range(RANKS):
        m = tm.init_moe(part, device="cpu", dtype=torch.float32, first_expert=r * held)
        assert tuple(m.w1.shape) == (held, whole.d_model, whole.expert_d_ff)
        with torch.no_grad():
            for name in ("w1", "w3", "w2"):
                getattr(m, name).copy_(getattr(full, name)[r * held:(r + 1) * held])
            m.router.copy_(full.router)
            for name in ("w1", "w3", "w2"):
                getattr(m.shared, name).copy_(getattr(full.shared, name))
        out, aux = tm.moe(m, x)
        got = got + (out - shared)
        assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_the_reference_s_held_shares_sum_to_the_uncut_layer():
    whole = dataclasses.replace(get_smoke_config(NAME), moe_capacity_factor=0.5)
    arch = _arch(whole)
    w = _weights(whole)
    x = torch.randn(2, 32, whole.d_model, generator=torch.Generator().manual_seed(7))
    frac = torch.full((whole.moe_experts,), 1 / whole.moe_experts)
    ident = LM_REF._rounder("float32")
    want, want_aux, _ = REF.Model(arch, w, ident).moe(0, x, x.shape[0] * x.shape[1], frac)
    no_shared = dict(arch, moe_shared_d_ff=0)
    shared = want - REF.Model(no_shared, w, ident).moe(0, x, x.shape[0] * x.shape[1], frac)[0]
    held = whole.moe_experts // RANKS
    got = shared
    for r in range(RANKS):
        wr = {k: v[:, r * held:(r + 1) * held] if k.endswith(("ffn/w1", "ffn/w3", "ffn/w2"))
              else v for k, v in w.items()}
        model = REF.Model(dict(arch, moe_experts_held=held), wr, ident, first_expert=r * held)
        out, aux, _ = model.moe(0, x, x.shape[0] * x.shape[1], frac)
        got = got + (out - shared)
        assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_a_share_builds_its_dispatch_over_its_own_experts_only():
    """The dispatch of a 2-of-8 share is (G, gs, 2, C): the einsum into the
    expert buffers sees only the held experts' axis."""
    cfg = dataclasses.replace(get_smoke_config(NAME), compute_dtype="float32",
                              moe_experts_held=2)
    m = tm.init_moe(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                    dtype=torch.float32, first_expert=6)
    seen = []
    real = torch.einsum

    def spy(eq, *ops):
        seen.append((eq, tuple(ops[0].shape)))
        return real(eq, *ops)

    torch.einsum = spy
    try:
        tm.moe(m, torch.randn(1, 32, cfg.d_model))
    finally:
        torch.einsum = real
    assert [s for eq, s in seen if eq == "gsec,gsd->gecd"][0][2] == 2


def test_a_share_is_refused_past_the_router_s_experts():
    cfg = dataclasses.replace(get_smoke_config(NAME), moe_experts_held=4)
    with pytest.raises(ValueError):
        tm.init_moe(cfg, device="cpu", first_expert=6)
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, moe_experts_held=9)


# ---------------------------------------------------------------------------
# NoPE, the multipliers, the tied head, the conv bias
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nope", [True, False])
def test_nope_attention_sees_positions_only_through_causality(nope):
    """Shuffling the tokens before the last leaves a NoPE layer's output at
    the last position as it was; with RoPE it moves."""
    cfg = dataclasses.replace(_cfg(), nope=nope)
    m = Attention(cfg, device="cpu", generator=torch.Generator().manual_seed(1),
                  dtype=torch.float32)
    x = torch.randn(1, 24, cfg.d_model, generator=torch.Generator().manual_seed(2))
    perm = torch.cat([torch.randperm(23, generator=torch.Generator().manual_seed(3)),
                      torch.tensor([23])])
    a = attention(m, x)[0][:, -1]
    b = attention(m, x[:, perm])[0][:, -1]
    assert torch.allclose(a, b, atol=1e-5) == nope


#: each piece at the value that leaves it out
PIECES = {"embedding_multiplier": 1.0, "residual_multiplier": 1.0, "logits_scaling": 1.0,
          "attention_multiplier": 0.0, "nope": False, "ssm_conv_bias": False}


@pytest.mark.parametrize("piece", sorted(PIECES))
def test_each_piece_moves_the_reference_far_past_the_match_s_tolerance(piece):
    """Left out of the reference, each piece moves its loss or its
    gradients by over 100x the tolerance that the port's match keeps, so a
    port that left it out would fail that match."""
    cfg = _cfg()
    w, toks = _weights(cfg), _tokens(cfg)
    ref = _ref_loss_grads(_arch(cfg), w, toks)
    arch = dict(_arch(cfg), **{piece: PIECES[piece]})
    if piece == "ssm_conv_bias":  # the reference reads the biases: without one they are 0
        w = {k: torch.zeros_like(v) if k.endswith("_bias") and "conv" in k else v
             for k, v in w.items()}
    loss_gap, grad_gap = _gaps(_ref_loss_grads(arch, w, toks), ref)
    assert loss_gap > 100 * LOSS_TOL or grad_gap > 100 * GRAD_TOL, (loss_gap, grad_gap)


def test_the_tied_head_is_the_table():
    """No head leaf; the logits move with a table row that no input token
    reads, by that row times the final hidden state over ``logits_scaling``."""
    cfg = _cfg()
    w = _weights(cfg)
    model = _port(cfg, w)
    assert not any(leaf.path[-1] == "head" for leaf in param_leaves(model))
    toks = _tokens(cfg, 1, 16) % 100
    base, _ = lm_forward(model, toks, remat=False)
    with torch.no_grad():
        model.embed.table[300] += 1.0
    moved, _ = lm_forward(model, toks, remat=False)
    diff = moved - base
    assert float(diff[..., 300].abs().min()) > 0
    assert float(torch.cat([diff[..., :300], diff[..., 301:]], -1).abs().max()) == 0


def test_the_conv_bias_is_a_leaf_of_each_filter_only_where_asked():
    cfg = _cfg()
    keys = {"/".join(leaf.path) for leaf in param_leaves(init_lm(cfg, device="cpu"))}
    assert {"periods/pos0/mixer/conv_x_bias", "periods/pos0/mixer/conv_B_bias",
            "periods/pos0/mixer/conv_C_bias"} <= keys
    off = {"/".join(leaf.path) for leaf in
           param_leaves(init_lm(dataclasses.replace(cfg, ssm_conv_bias=False), device="cpu"))}
    assert not any("bias" in k and "conv" in k for k in off)


def test_the_published_and_cut_parameter_counts():
    """32.2 B parameters, 8.8 B active (Granite 4.0-H Small, 32B-A9B); the
    benchmark's cut (one period, 9 of 72 experts) 2.41 B, of which a token
    meets 1,682,767,872: the frozen N of ``bench/counts/flops.py``."""
    cfg = get_config(NAME)
    assert round(cfg.param_count() / 1e9, 1) == 32.2
    assert round(cfg.active_param_count() / 1e9, 1) == 8.8
    cut = dataclasses.replace(cfg, tp=1, n_layers=10, moe_experts_held=9)
    assert cut.param_count() == 2_414_149_632
    assert cut.active_param_count() == 1_682_767_872


# ---------------------------------------------------------------------------
# at the defaults, nothing moves
# ---------------------------------------------------------------------------

#: per SMOKE configuration, as before the new fields: (leaves, their paths
#: and shapes' digest, aten operations of a forward and backward, the
#: logits' sum and absolute sum, the aux loss) on seed-0 weights; the
#: operations are counted with the bidirectional attentions' unpadded key
#: chunks run without a mask (vision and seamless: 20 and 64 fewer), and the
#: MoE's routing builds every choice's one-hot in one comparison (olmoe,
#: scout and jamba: 48, 12 and 132 fewer)
BEFORE = {
    "llama-3.2-vision-11b": (49, "505e97ad125bed3b", 5247, -122.88737869262695, 6492.536198616028, 0.0),
    "olmoe-1b-7b": (15, "5ace5c9ad54e1380", 2794, -205.619779586792, 6590.105089187622, 2.6870269775390625),
    "llama4-scout-17b-a16e": (13, "f2f9ea240be09e06", 2490, -375.27029514312744, 6567.145293712616, 2.1402788162231445),
    "phi4-mini-3.8b": (12, "f9eb3c695ed454fa", 1787, 67.91888046264648, 6567.855472564697, 0.0),
    "granite-20b": (12, "15a8241752d86190", 1787, 13.169188499450684, 6520.8899602890015, 0.0),
    "deepseek-67b": (12, "6ddf35ae0abd5b8e", 2665, -107.93751430511475, 6544.538266181946, 0.0),
    "qwen3-0.6b": (14, "5da618bbc8c8ba3c", 1993, -192.30833911895752, 6537.275958061218, 0.0),
    "mamba2-370m": (17, "d6b21b10287045f7", 2149, -3.885310173034668, 6619.5576639175415, 0.0),
    "jamba-1.5-large-398b": (142, "8c9b978ec528c313", 13302, -61.52598249912262, 6472.694136977196, 4.387024879455566),
    "seamless-m4t-large-v2": (27, "ea940fdf0597b143", 4001, -242.43186235427856, 6588.970801830292, 0.0),
}


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_at_the_defaults_every_configuration_keeps_its_leaves_ops_and_outputs(name):
    cfg = get_smoke_config(name)
    model = init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                    dtype="float32")
    leaves = param_leaves(model)
    digest = hashlib.sha256("\n".join(f"{'/'.join(leaf.path)}:{tuple(leaf.shape)}"
                                      for leaf in leaves).encode()).hexdigest()[:16]
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 8)))
    ctx = None
    if cfg.n_context_tokens or cfg.is_encdec:
        ctx = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (2, cfg.n_context_tokens or 8, cfg.d_model)).astype(np.float32))
    with _Count() as count:
        logits, aux = lm_forward(model, toks, cross_src=ctx)
        (logits.float().square().mean() + aux).backward()
    n, want_digest, ops, total, absolute, want_aux = BEFORE[name]
    assert (len(leaves), digest, count.n) == (n, want_digest, ops)
    got = logits.detach().double()
    assert float(got.sum()) == pytest.approx(total, rel=1e-6, abs=1e-3)
    assert float(got.abs().sum()) == pytest.approx(absolute, rel=1e-6)
    assert float(aux) == pytest.approx(want_aux, rel=1e-6)


# ---------------------------------------------------------------------------
# serving, and the trace
# ---------------------------------------------------------------------------

def test_prefill_then_decode_gives_the_full_forward_s_logits():
    """The SMOKE model (every expert, capacity past any drop, so that the
    one-token groups of decode route as the forward's groups do) in float32:
    the score scale in the decode kernel's queries, NoPE, the conv biases'
    tails, the multipliers and the tied head on both paths."""
    cfg = dataclasses.replace(get_smoke_config(NAME), compute_dtype="float32",
                              moe_capacity_factor=8.0)
    model = init_lm(cfg, generator=torch.Generator().manual_seed(4), device="cpu")
    with torch.no_grad():
        for blk in model.layers:
            if blk.kind == "mamba":
                for name in ("conv_x_bias", "conv_B_bias", "conv_C_bias"):
                    getattr(blk.mixer, name).normal_(0, 0.5, generator=torch.Generator()
                                                     .manual_seed(5))
    toks = _tokens(cfg, 2, 20, seed=6)
    full, _ = lm_forward(model, toks, remat=False)
    logits, caches = lm_prefill(model, toks[:, :12], cache_dtype=torch.float32, max_seq=20)
    torch.testing.assert_close(logits, full[:, 11], rtol=1e-4, atol=1e-4)
    for t in range(12, 20):
        logits, caches = lm_decode(model, caches, toks[:, t], t)
        torch.testing.assert_close(logits, full[:, t], rtol=1e-4, atol=1e-4)


def test_the_moe_counters_and_the_shared_span_under_a_recorder():
    cfg = _cfg(moe_capacity_factor=0.5)
    model = _port(cfg, _weights(cfg))
    toks = _tokens(cfg)
    lm_forward(model, toks, remat=False)  # no recorder: nothing recorded anywhere
    rec = obs.TraceRecorder()
    with torch.no_grad(), rec.installed():
        lm_forward(model, toks, remat=False)
    c = rec.counters
    assert c["moe.slots"] == toks.numel() * cfg.moe_top_k * cfg.n_layers
    assert 0 < c["moe.dropped_held"] < c["moe.slots_held"] < c["moe.slots"]
    names = [s.name for s in rec.spans]
    assert names.count("moe.shared") == names.count("moe.dispatch") == cfg.n_layers
