"""The port's LM stack (repro_torch.models, configs, interop.lm_from_numpy) on
the CPU against the reference package on the same weights.

The reference's ``init_lm`` pytree (``PRNGKey(0)``) is carried across as
numpy arrays with ``lm_from_numpy`` (the ``cross`` layers' ``gate``, which the
reference initialises to 0 and so would hide the cross-attention's output,
is set to 0.5 in both); inputs and the context embeddings (``cross_src``,
rounded to bfloat16 as the reference's launcher makes them) come from
``numpy.random.default_rng``.  The SMOKE configs are run with
``compute_dtype="float32"`` and with the default bfloat16:

* per module — ``rms_norm``, ``apply_rope``, prefill ``attention`` (with
  its block cache; and as cross-attention with ``kv_x``, as the encoder's
  ``causal=False``, and without RoPE), ``decode_attention_blocks`` (scalar
  and per-lane positions), ``decode_cross_attention``, ``mlp``, ``encode``,
  ``mamba_train``, ``mamba_decode`` — within 1e-4 in float32;
* the slice — ``lm_forward`` (logits and the MoE aux loss), ``lm_prefill``
  and three ``lm_decode`` steps, logits and caches, for qwen3-0.6b,
  mamba2-370m, olmoe-1b-7b, llama4-scout-17b-a16e, jamba-1.5-large-398b,
  llama-3.2-vision-11b and seamless-m4t-large-v2 (the last two with
  ``cross_src``): within 1e-4 with float32 compute (the aux within 1e-6
  relative), and within the reference's relative max error of 0.06
  (``tests/test_archs.py``) with bfloat16 compute; qwen3 also at ``tp=4``
  (replicated stored KV heads) and ``tp=8`` (padded query heads and vocab).
  The bfloat16 cases of the MoE families are held to the reference run op
  by op (``jax.disable_jit()``), where every jnp operation rounds to
  bfloat16 as its dtype says: compiled, XLA keeps float32 intermediates
  inside its fusions, and one unit of difference in a router's input
  flips a near-tied top-k choice, which moves that token's logits by
  0.1-0.3 at SMOKE size (the routing, not the port: the same weights give
  equal aux losses and logits op by op);
* the port's own prefill/decode consistency for the MoE families at
  ``moe_capacity_factor=8.0`` (``tests/test_archs.py``'s check and limits),
  and every one of the ten configurations builds and runs ``lm_forward``.

Cache tensors stored in bfloat16 (the KV cache and the conv tails, as in the
reference, also under float32 compute) are compared within one bfloat16
rounding step (2^-7 relative): the port computes the stored value to ~1e-7
of the reference, and a value that close to a rounding midpoint may round
the other way.  Float32 cache tensors (the SSM state; every cache of the
later families under float32 compute, see ``LATER_FAMILIES``) are held to
1e-4.
"""
import contextlib
import dataclasses
import functools

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as jl
from repro.models import mamba2 as jm
from repro.models.lm import encode as jax_encode
from repro.models.lm import init_lm as jax_init_lm
from repro.models.lm import lm_decode as jax_lm_decode
from repro.models.lm import lm_forward as jax_lm_forward
from repro.models.lm import lm_prefill as jax_lm_prefill
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.interop import lm_from_numpy
from repro_torch.models import layers as tl
from repro_torch.models import mamba2 as tm
from repro_torch.models import blocks as tb
from repro_torch.models import lm as tlm
from repro_torch.models.lm import LM, init_caches, init_lm, lm_decode, lm_forward, lm_prefill

BF16_STEP = 2.0 ** -7  # one bfloat16 rounding step, relative to the value
GATE = 0.5  # the cross layers' gate in the compared weights (the reference's init is 0)


@pytest.fixture(autouse=True)
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)  # torch's default


@functools.lru_cache(maxsize=None)
def _params(arch: str, tp: int):
    """The reference's weights (independent of the compute dtype) as numpy,
    with every ``cross`` layer's gate at ``GATE``."""
    cfg = dataclasses.replace(jax_smoke(arch), tp=tp)
    params = jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(0), cfg))
    for i, kind in enumerate(cfg.period):
        if kind == "cross":
            pos = params["periods"][f"pos{i}"]
            pos["gate"] = np.full_like(pos["gate"], GATE)
    return params


def _context(cfg, B: int, seed: int = 8):
    """Context embeddings (B, n_context_tokens, d) as the launcher draws them
    (normal * 0.02, bfloat16), as (jax, torch) arrays; (None, None) for a
    configuration without cross-attention."""
    if cfg.family not in ("vlm", "encdec"):
        return None, None
    x = np.random.default_rng(seed).normal(size=(B, cfg.n_context_tokens, cfg.d_model)) * 0.02
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


@functools.lru_cache(maxsize=None)
def _smoke(arch: str, cd: str = "float32", tp: int = 1):
    """(jax cfg, port cfg, numpy params, port model) for a SMOKE config."""
    jcfg = dataclasses.replace(jax_smoke(arch), compute_dtype=cd, tp=tp)
    tcfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=cd, tp=tp)
    params = _params(arch, tp)
    return jcfg, tcfg, params, lm_from_numpy(tcfg, params, device="cpu")


def _layer(params, i=0):
    """Layer ``i``'s parameter dict (period 0's position i) in the reference's form."""
    return jax.tree.map(lambda a: a[0], params["periods"][f"pos{i}"])


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _rel(got, want) -> float:
    g, w = _f32(got), _f32(want)
    return float(np.abs(g - w).max() / max(1.0, float(np.abs(w).max())))


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def _cache_close(got: torch.Tensor, want, tol):
    """A cache tensor: bfloat16 storage within one rounding step (plus
    ``tol``), float32 storage within ``tol``."""
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape
    if got.dtype == torch.bfloat16:
        assert np.all(np.abs(g - w) <= BF16_STEP * np.abs(w) + tol), float(np.abs(g - w).max())
    else:
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def _compare_caches(port: list, ref: dict, cfg, check):
    """Every layer's cache slot of the port against the reference's stacked
    slots (``ref["pos{i}"][key]`` with a leading period axis)."""
    n = len(cfg.period)
    assert len(port) == cfg.n_layers
    for layer, slot in enumerate(port):
        p, i = divmod(layer, n)
        assert set(slot) == set(ref[f"pos{i}"])
        for key, obj in slot.items():
            robj = ref[f"pos{i}"][key]
            if isinstance(obj, torch.Tensor):  # the context's K/V
                check(obj, np.asarray(robj)[p])
                continue
            for f in dataclasses.fields(obj):
                check(getattr(obj, f.name), np.asarray(getattr(robj, f.name))[p])


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
@pytest.mark.parametrize("name", JAX_ARCH_NAMES)
def test_config_copies_equal_the_reference(name, smoke):
    ref = (jax_smoke if smoke else jax_get_config)(name)
    got = (get_smoke_config if smoke else get_config)(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    for prop in ("n_periods", "padded_vocab", "ssm_heads" if got.has_ssm else "q_per_kv"):
        assert getattr(got, prop) == getattr(ref, prop)
    assert got.param_count() == ref.param_count()
    assert ARCH_NAMES == JAX_ARCH_NAMES


@pytest.mark.parametrize("name", JAX_ARCH_NAMES)
def test_every_configuration_builds_and_runs_forward(name):
    """No configuration is refused: each SMOKE config builds and runs
    ``lm_forward`` on the CPU (finite logits; an aux loss > 0 with experts)."""
    cfg = get_smoke_config(name)
    model = init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 8)))
    logits, aux = lm_forward(model, toks, cross_src=_context(cfg, 2)[1])
    assert logits.shape == (2, 8, cfg.padded_vocab) and torch.isfinite(logits).all()
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert (float(aux) > 0) == bool(cfg.moe_experts)


# ---------------------------------------------------------------------------
# per module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 24)).astype(np.float32)
    s = rng.normal(size=(24,)).astype(np.float32)
    got = tl.rms_norm(torch.from_numpy(x).to(dtype), torch.from_numpy(s))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jl.rms_norm(jnp.asarray(x, jdt), {"scale": jnp.asarray(s)})
    assert got.dtype == dtype
    if dtype == torch.float32:
        _close(got, want, 1e-6)
    else:
        _cache_close(got, want, 0.0)


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope(per_row):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = np.arange(5)[None] + (np.array([[0], [7]]) if per_row else 0)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    _close(got, jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-5)


def test_attention_prefill_and_its_block_cache():
    jcfg, tcfg, params, model = _smoke("qwen3-0.6b")
    p = _layer(params)["mixer"]
    x = np.random.default_rng(2).normal(size=(2, 13, jcfg.d_model)).astype(np.float32)
    pos = np.arange(13)[None]
    want, wcache = jl.attention(p, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                                cache=jl.KVCache.zeros(jcfg, 2, 40))
    cache = tl.KVCache.zeros(tcfg, 2, 40, device="cpu")
    got, gcache = tl.attention(model.layers[0].mixer, torch.from_numpy(x),
                               positions=torch.from_numpy(pos), cache=cache)
    assert gcache is cache
    _close(got, want, 1e-4)
    _cache_close(cache.k, wcache.k, 1e-4)
    _cache_close(cache.v, wcache.v, 1e-4)
    # without a cache, chunked over 4-position query and key chunks
    want, _ = jl.attention(p, jnp.asarray(x), jcfg, chunk=4)
    got, none = tl.attention(model.layers[0].mixer, torch.from_numpy(x), chunk=4)
    assert none is None
    _close(got, want, 1e-4)


@pytest.mark.parametrize("position", [9, [9, 3]], ids=["scalar", "per-lane"])
def test_decode_attention_blocks(position):
    jcfg, tcfg, params, model = _smoke("qwen3-0.6b")
    p = _layer(params, 0)["mixer"]
    rng = np.random.default_rng(3)
    shape = jl.KVCache.zeros(jcfg, 2, 32).k.shape
    k0 = np.array(jnp.asarray(rng.normal(size=shape), jnp.bfloat16).astype(jnp.float32))
    v0 = np.array(jnp.asarray(rng.normal(size=shape), jnp.bfloat16).astype(jnp.float32))
    x = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    jpos = jnp.asarray(position, jnp.int32)
    want, wcache = jl.decode_attention_blocks(
        p, jnp.asarray(x), jl.KVCache(jnp.asarray(k0, jnp.bfloat16), jnp.asarray(v0, jnp.bfloat16)),
        jpos, jcfg)
    cache = tl.KVCache(torch.from_numpy(k0).bfloat16(), torch.from_numpy(v0).bfloat16())
    got, gcache = tl.decode_attention_blocks(model.layers[0].mixer, torch.from_numpy(x), cache,
                                             torch.tensor(position))
    assert gcache is cache
    _close(got, want, 1e-4)
    _cache_close(cache.k, wcache.k, 1e-4)
    _cache_close(cache.v, wcache.v, 1e-4)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_mlp(cd):
    jcfg, tcfg, params, model = _smoke("qwen3-0.6b", cd)
    x = np.random.default_rng(4).normal(size=(2, 3, jcfg.d_model)).astype(np.float32)
    got = tl.mlp(model.layers[1].ffn, torch.from_numpy(x))
    want = jl.mlp(jax.tree.map(lambda a: a[1], params["periods"]["pos0"])["ffn"],
                  jnp.asarray(x), jcfg)
    if cd == "float32":
        _close(got, want, 1e-4)
    else:
        assert _rel(got, want) < 0.06


@pytest.mark.parametrize("S", [16, 12, 5], ids=["chunks", "padded", "short"])
def test_mamba_train(S):
    jcfg, tcfg, params, model = _smoke("mamba2-370m")
    x = np.random.default_rng(5).normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    want = jm.mamba_train(_layer(params)["mixer"], jnp.asarray(x), jcfg)
    got = tm.mamba_train(model.layers[0].mixer, torch.from_numpy(x))
    _close(got, want, 1e-4)


def test_mamba_decode():
    jcfg, tcfg, params, model = _smoke("mamba2-370m")
    rng = np.random.default_rng(6)
    ref0 = jm.MambaCache.zeros(jcfg, 2)
    fields = [np.array(jnp.asarray(rng.normal(size=f.shape), f.dtype).astype(jnp.float32))
              for f in (ref0.conv_x, ref0.conv_B, ref0.conv_C)]
    state = rng.normal(size=ref0.state.shape).astype(np.float32)
    x = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    want, wcache = jm.mamba_decode(
        _layer(params)["mixer"], jnp.asarray(x),
        jm.MambaCache(*(jnp.asarray(f, jnp.bfloat16) for f in fields), jnp.asarray(state)), jcfg)
    cache = tm.MambaCache(*(torch.from_numpy(f).bfloat16() for f in fields),
                          torch.from_numpy(state))
    got, gcache = tm.mamba_decode(model.layers[0].mixer, torch.from_numpy(x), cache)
    assert gcache is cache
    _close(got, want, 1e-4)
    for f in dataclasses.fields(cache):
        _cache_close(getattr(cache, f.name), getattr(wcache, f.name), 1e-4)


ATTN_MODES = {  # attention's keyword arguments; "kv_x": the context as K/V source
    "cross": dict(kv_x=True, causal=False, rope=False),  # VLM / decoder cross layers
    "cross-rope": dict(kv_x=True, causal=False, rope=True),  # queries rotate, K does not
    "encoder": dict(causal=False, rope=True),
    "causal-no-rope": dict(causal=True, rope=False),
}


@pytest.mark.parametrize("mode", list(ATTN_MODES))
def test_attention_modes(mode):
    jcfg, tcfg, params, model = _smoke("llama-3.2-vision-11b")
    p = _layer(params, 4)["mixer"]  # the period's cross layer
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 7, jcfg.d_model)).astype(np.float32)
    src = rng.normal(size=(2, 11, jcfg.d_model)).astype(np.float32)
    kw = dict(ATTN_MODES[mode])
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("kv_x", None):
        jkw["kv_x"], tkw["kv_x"] = jnp.asarray(src), torch.from_numpy(src)
    want, _ = jl.attention(p, jnp.asarray(x), jcfg, chunk=4, **jkw)
    got, none = tl.attention(model.layers[4].mixer, torch.from_numpy(x), chunk=4, **tkw)
    assert none is None and got.shape == (2, 7, jcfg.d_model)
    _close(got, want, 1e-4)


def test_decode_cross_attention():
    jcfg, tcfg, params, model = _smoke("seamless-m4t-large-v2")
    p = _layer(params, 0)["cross"]
    rng = np.random.default_rng(10)
    shape = (2, 9, jcfg.stored_kv_heads, jcfg.head_dim)
    k = np.array(jnp.asarray(rng.normal(size=shape), jnp.bfloat16).astype(jnp.float32))
    v = np.array(jnp.asarray(rng.normal(size=shape), jnp.bfloat16).astype(jnp.float32))
    x = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    want = jl.decode_cross_attention(p, jnp.asarray(x), jnp.asarray(k, jnp.bfloat16),
                                     jnp.asarray(v, jnp.bfloat16), jcfg)
    got = tl.decode_cross_attention(model.layers[0].cross, torch.from_numpy(x),
                                    torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16())
    _close(got, want, 1e-4)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_encode(cd):
    jcfg, tcfg, params, model = _smoke("seamless-m4t-large-v2", cd)
    jsrc, tsrc = _context(jcfg, 2)
    want = jax_encode(params["encoder"], jsrc, jcfg)
    got = tlm.encode(model.encoder, tsrc)
    assert got.dtype == getattr(torch, cd) and got.shape == tuple(jsrc.shape)
    if cd == "float32":
        _close(got, want, 1e-4)
    else:
        assert _rel(got, want) < 0.06, _rel(got, want)


# ---------------------------------------------------------------------------
# the slice: forward, prefill, three decode steps
# ---------------------------------------------------------------------------

#: the MoE, hybrid, VLM and encoder-decoder families.  With float32 compute
#: their caches are float32 in both packages: their decode reads many
#: bfloat16-stored values (the context's K/V, seven Mamba layers' conv tails),
#: and one stored at a rounding midpoint rounds apart and moves a decode logit
#: by up to 4e-4 (jamba, seamless at SMOKE size)
LATER_FAMILIES = ("olmoe-1b-7b", "llama4-scout-17b-a16e", "jamba-1.5-large-398b",
                  "llama-3.2-vision-11b", "seamless-m4t-large-v2")
SLICE = [("qwen3-0.6b", "float32", 1), ("qwen3-0.6b", "bfloat16", 1),
         ("mamba2-370m", "float32", 1), ("mamba2-370m", "bfloat16", 1),
         ("qwen3-0.6b", "float32", 4), ("qwen3-0.6b", "float32", 8)] + [
    (arch, cd, 1) for arch in LATER_FAMILIES for cd in ("float32", "bfloat16")]


@pytest.mark.parametrize("arch,cd,tp", SLICE, ids=[f"{a}-{c}-tp{t}" for a, c, t in SLICE])
def test_forward_prefill_and_decode_match_the_reference(arch, cd, tp):
    jcfg, tcfg, params, model = _smoke(arch, cd, tp)
    B, S, max_seq = 2, 12, 32
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, size=(B, S)).astype(np.int32)
    jsrc, tsrc = _context(jcfg, B)
    f32 = cd == "float32"
    f32_caches = f32 and arch in LATER_FAMILIES
    # bfloat16 MoE: the reference op by op (see the module docstring)
    reference = (contextlib.nullcontext if f32 or not jcfg.moe_experts else jax.disable_jit)

    def check_logits(got, want):
        assert got.shape == want.shape and torch.isfinite(got).all()
        if f32:
            _close(got, want, 1e-4)
        else:
            assert _rel(got, want) < 0.06, _rel(got, want)

    def check_cache(got, want):
        if f32:
            _cache_close(got, want, 1e-4)
        else:
            assert _rel(got, want) < 0.06, _rel(got, want)

    with reference():
        want, waux = jax_lm_forward(params, jnp.asarray(toks), jcfg, cross_src=jsrc, remat=False)
    got, aux = lm_forward(model, torch.from_numpy(toks), cross_src=tsrc)
    assert got.shape == (B, S, tcfg.padded_vocab) and aux.dtype == torch.float32
    check_logits(got, want)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6, atol=1e-6)
    assert (float(aux) > 0) == bool(jcfg.moe_experts)

    with reference():
        want, wcaches = jax_lm_prefill(params, jnp.asarray(toks), jcfg, cross_src=jsrc,
                                       max_seq=max_seq,
                                       cache_dtype=jnp.float32 if f32_caches else jnp.bfloat16)
    got, caches = lm_prefill(model, torch.from_numpy(toks), cross_src=tsrc, max_seq=max_seq,
                             cache_dtype=torch.float32 if f32_caches else torch.bfloat16)
    check_logits(got, want)
    _compare_caches(caches, wcaches, tcfg, check_cache)
    decode = jax.jit(lambda p, c, t, pos: jax_lm_decode(p, c, t, pos, jcfg))
    for step in range(3):
        nxt = np.argmax(_f32(want)[:, :jcfg.vocab], -1).astype(np.int32)
        with reference():
            want, wcaches = decode(params, wcaches, jnp.asarray(nxt), jnp.int32(S + step))
        got, same = lm_decode(model, caches, torch.from_numpy(nxt), S + step)
        assert same is caches  # updated in place
        check_logits(got, want)
    _compare_caches(caches, wcaches, tcfg, check_cache)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-scout-17b-a16e", "jamba-1.5-large-398b"])
def test_moe_prefill_decode_consistency(arch):
    """The port's decode over filled caches against its own forward over the
    extended sequence (``tests/test_archs.py``'s check, bfloat16, with a
    no-drop capacity factor: dropping is a forward/decode semantic
    difference; the hybrid's limit 0.12, the others' 0.06)."""
    cfg = dataclasses.replace(get_smoke_config(arch), moe_capacity_factor=8.0)
    model = lm_from_numpy(cfg, _params(arch, 1), device="cpu")
    B, S = 2, 16
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, size=(B, S)))
    last, caches = lm_prefill(model, tokens, max_seq=2 * S)
    full, _ = lm_forward(model, tokens)
    np.testing.assert_allclose(_f32(last), _f32(full[:, -1]), rtol=1e-2, atol=1e-2)
    nxt = torch.argmax(last[:, :cfg.vocab], -1)
    dec, _ = lm_decode(model, caches, nxt, S)
    full2, _ = lm_forward(model, torch.cat([tokens, nxt[:, None]], 1))
    err = _rel(dec, full2[:, -1])
    assert err < (0.12 if cfg.family == "hybrid" else 0.06), err


def test_cross_and_dec_cache_slots():
    """``cache_position`` gives ``cross`` the context's K/V and ``dec`` the
    KV cache beside them; ``_capacity`` finds the KV cache behind a cross
    slot."""
    from repro_torch.models.blocks import cache_position

    cfg = get_smoke_config("seamless-m4t-large-v2")
    cross = cache_position("cross", cfg, 2, 40, device="cpu", src_len=9)
    dec = cache_position("dec", cfg, 2, 40, torch.float32, device="cpu", src_len=9)
    want = (2, 9, cfg.stored_kv_heads, cfg.head_dim)
    assert set(cross) == {"cross_k", "cross_v"} and set(dec) == {"kv", "cross_k", "cross_v"}
    assert tuple(cross["cross_k"].shape) == want and cross["cross_v"].dtype == torch.bfloat16
    assert tuple(dec["cross_v"].shape) == want and dec["cross_k"].dtype == torch.float32
    assert tuple(dec["kv"].k.shape) == (2, 3, cfg.stored_kv_heads, cfg.kv_block, cfg.head_dim)
    assert tlm._capacity([cross, dec]) == 48 and tlm._capacity([cross]) is None
    with pytest.raises(RuntimeError, match="needs a CUDA device") if not torch.cuda.is_available() \
            else contextlib.nullcontext():
        cache_position("cross", cfg, 1, 8, src_len=4)


def test_stored_kv_heads_and_padding_follow_tp():
    """tp=4 replicates qwen3-smoke's 2 kv heads to 4; tp=8 also pads its 4
    query heads to 8 (zero weights) and the vocab from 512 to 1024."""
    for tp, hkv, hq, vp in ((4, 4, 4, 512), (8, 8, 8, 1024)):
        model = _smoke("qwen3-0.6b", "float32", tp)[3]
        mix = model.layers[0].mixer
        assert mix.wk.shape[1] == hkv and mix.wq.shape[1] == hq
        assert model.embed.head.shape[1] == vp
        assert torch.equal(mix.wk[:, 0::2], mix.wk[:, 1::2])  # replicated real heads
        assert not mix.wq[:, 4:].any() and not mix.wo[4:].any()


# ---------------------------------------------------------------------------
# init, load, capacity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-370m"])
def test_init_lm_draws_the_reference_shapes_and_scales(arch):
    cfg = get_smoke_config(arch)
    a = init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    b = init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    ref = jax.eval_shape(lambda k: jax_init_lm(k, jax_smoke(arch)), jax.random.PRNGKey(0))
    n_ref = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(ref))
    assert sum(p.numel() for p in a.parameters()) == n_ref
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), name  # a seed fixes every value
        assert p.device.type == "cpu" and not p.requires_grad
    std = float(a.embed.head.float().std())
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert a.embed.table.dtype == torch.bfloat16 and a.final_norm.dtype == torch.float32


def test_lm_from_numpy_rejects_a_pytree_that_does_not_fit():
    jcfg, tcfg, params, _ = _smoke("qwen3-0.6b")
    short = dict(params, final_norm={})
    with pytest.raises(ValueError, match="final_norm"):
        lm_from_numpy(tcfg, short, device="cpu")
    extra = dict(params, stray={"w": np.zeros(3)})
    with pytest.raises(ValueError, match="stray.w"):
        lm_from_numpy(tcfg, extra, device="cpu")
    bad = jax.tree.map(lambda a: a, params)
    bad["embed"] = dict(bad["embed"], head=bad["embed"]["head"][:, :7])
    with pytest.raises(ValueError, match="embed.head: shape"):
        lm_from_numpy(tcfg, bad, device="cpu")


def test_decode_past_the_cache_raises():
    _, tcfg, _, model = _smoke("qwen3-0.6b")
    caches = init_caches(tcfg, 2, 16, device="cpu")
    with pytest.raises(IndexError, match="outside the caches' 16 slots"):
        lm_decode(model, caches, torch.tensor([1, 2]), 16)
    with pytest.raises(IndexError, match="outside"):
        lm_decode(model, caches, torch.tensor([1, 2]), np.array([3, 16]))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    cfg = get_smoke_config("qwen3-0.6b")
    for call in (lambda: init_lm(cfg), lambda: init_caches(cfg, 1, 8), lambda: LM(cfg)):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            call()


def test_cache_constructors_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    from repro_torch.models.blocks import cache_position

    cfg = get_smoke_config("mamba2-370m")
    for call in (lambda **kw: tl.KVCache.zeros(cfg, 1, 8, **kw),
                 lambda **kw: tm.MambaCache.zeros(cfg, 1, **kw),
                 lambda **kw: cache_position("attn", cfg, 1, 8, **kw),
                 lambda **kw: cache_position("mamba", cfg, 1, 8, **kw)):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            call()
        cache = call(device="cpu")
        for c in cache.values() if isinstance(cache, dict) else [cache]:
            assert all(getattr(c, f.name).device.type == "cpu" for f in dataclasses.fields(c))


@pytest.mark.parametrize("make", [
    lambda cfg, **kw: tl.Attention(cfg, **kw),
    lambda cfg, **kw: tl.MLP(cfg, **kw),
    lambda cfg, **kw: tl.Embedding(cfg, **kw),
    lambda cfg, **kw: tm.Mamba2(cfg, **kw),
    lambda cfg, **kw: tb.Block("attn", "mlp", cfg, **kw),
    lambda cfg, **kw: tb.init_position("mamba", "none", cfg, **kw),
    lambda cfg, **kw: tlm.Encoder(cfg, **kw),
], ids=["Attention", "MLP", "Embedding", "Mamba2", "Block", "init_position", "Encoder"])
def test_module_constructors_default_to_the_card(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    cfg = get_smoke_config("seamless-m4t-large-v2")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        make(cfg)
    for device in ("cpu", "meta"):
        assert all(p.device.type == device for p in make(cfg, device=device).parameters())
