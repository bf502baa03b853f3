"""The port's Mixture-of-Experts FFN (repro_torch.models.moe) on the CPU
against the reference's ``repro.models.moe.moe`` on the same weights and
inputs.

The reference's ``init_moe`` weights (``PRNGKey(0)``) are loaded into the
port's ``MoE``; token activations come from ``numpy.random.default_rng``.
The SMOKE configs of olmoe-1b-7b (top-2 of 8 experts), llama4-scout-17b-a16e
(top-1 of 4) and jamba-1.5-large-398b (top-2 of 4), group size 32:

* outputs within 1e-5 with float32 compute and within the reference's
  relative max error of 0.06 (``tests/test_archs.py``) with bfloat16; the
  load-balance aux loss within 1e-6 — for T a multiple of the group size,
  T not a multiple (a padded last group) and T below the group size;
* a dropping case (``moe_capacity_factor=0.25``): the routing is shown to
  overflow an expert's capacity (so tokens are dropped, which changes their
  outputs against a no-drop run), and the outputs still match;
* tied router columns: ``top_k`` orders equal probabilities as
  ``jax.lax.top_k`` does (the lower expert first), and with capacity
  pressure, where that order decides who is dropped, the outputs match;
* ``init_moe``: the reference's shapes and dtypes, and its scales
  (router and w1/w3 at d^-0.5, w2 at f^-0.5).
"""
import dataclasses
import functools

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_smoke
from repro.models import moe as jm
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as tm

ARCHS = ["olmoe-1b-7b", "llama4-scout-17b-a16e", "jamba-1.5-large-398b"]
SHAPES = {"multiple": (2, 16), "padded": (3, 15), "short": (1, 5)}  # (B, S); group size 32


@pytest.fixture(autouse=True)
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)  # torch's default


def _cfgs(arch: str, cd: str, **kw):
    return (dataclasses.replace(jax_smoke(arch), compute_dtype=cd, **kw),
            dataclasses.replace(get_smoke_config(arch), compute_dtype=cd, **kw))


@functools.lru_cache(maxsize=None)
def _weights(arch: str) -> dict:
    """The reference's ``init_moe`` weights as numpy (float32 parameters)."""
    return jax.tree.map(np.asarray, jm.init_moe(jax.random.PRNGKey(0), jax_smoke(arch)))


def _port(tcfg, w: dict) -> tm.MoE:
    m = tm.MoE(tcfg, device="cpu")
    with torch.no_grad():
        for name, arr in w.items():
            p = getattr(m, name)
            p.copy_(torch.tensor(np.asarray(arr)).to(p.dtype))
    return m


def _x(cfg, B, S, seed=0) -> np.ndarray:
    """Activations as the block feeds them: rounded to the compute dtype."""
    x = np.random.default_rng(seed).normal(size=(B, S, cfg.d_model))
    return np.asarray(jnp.asarray(x, cfg.compute_dtype).astype(jnp.float32))


def _run_both(arch, cd, B, S, w=None, seed=0, **kw):
    jcfg, tcfg = _cfgs(arch, cd, **kw)
    w = _weights(arch) if w is None else w
    x = _x(jcfg, B, S, seed)
    want, waux = jm.moe(jax.tree.map(jnp.asarray, w), jnp.asarray(x, jcfg.compute_dtype), jcfg)
    got, aux = tm.moe(_port(tcfg, w), torch.tensor(x).to(getattr(torch, cd)))
    return (got, aux), (np.asarray(want, np.float32), float(waux)), jcfg, x


def _check(got, want, cd):
    (out, aux), (wout, waux) = got, want
    g = out.float().numpy()
    assert out.dtype == getattr(torch, cd) and g.shape == wout.shape
    if cd == "float32":
        np.testing.assert_allclose(g, wout, rtol=1e-5, atol=1e-5)
    else:
        rel = float(np.abs(g - wout).max() / max(1.0, float(np.abs(wout).max())))
        assert rel < 0.06, rel
    assert aux.dtype == torch.float32 and abs(float(aux) - waux) <= 1e-6, (float(aux), waux)


def _routing(cfg, w: dict, x: np.ndarray):
    """Tokens per (group, expert) over all k choices (pad tokens excluded)
    and the capacity, recomputed from the router in numpy."""
    T = x.shape[0] * x.shape[1]
    gs = min(cfg.moe_group_size, T)
    xt = np.zeros((-(-T // gs) * gs, cfg.d_model), np.float32)
    xt[:T] = x.reshape(T, -1)
    logits = xt.reshape(-1, gs, cfg.d_model) @ w["router"]
    top = np.argsort(-logits, axis=-1, kind="stable")[..., :cfg.moe_top_k]
    valid = (np.arange(xt.shape[0]) < T).reshape(-1, gs)
    counts = np.zeros((top.shape[0], cfg.moe_experts), int)
    for g in range(top.shape[0]):
        for s in np.nonzero(valid[g])[0]:
            counts[g, top[g, s]] += 1
    cap = max(1, int(gs * cfg.moe_top_k * cfg.moe_capacity_factor / cfg.moe_experts))
    return counts, -(-cap // 4) * 4


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_the_reference(arch, cd, shape):
    got, want, _, _ = _run_both(arch, cd, *SHAPES[shape])
    _check(got, want, cd)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_tokens_as_the_reference_does(arch, cd):
    got, want, jcfg, x = _run_both(arch, cd, 2, 16, moe_capacity_factor=0.25)
    counts, cap = _routing(jcfg, _weights(arch), x)
    assert counts.max() > cap, (counts, cap)  # some expert overflows: tokens are dropped
    _check(got, want, cd)
    no_drop, _, _, _ = _run_both(arch, cd, 2, 16, moe_capacity_factor=8.0)
    assert not torch.equal(got[0], no_drop[0])  # dropping changed some outputs


def test_top_k_breaks_ties_as_jax_lax_top_k():
    probs = np.array([[0.2, 0.3, 0.3, 0.1, 0.1], [0.25, 0.25, 0.25, 0.25, 0.0],
                      [0.1, 0.1, 0.1, 0.1, 0.6]], np.float32)
    for k in (1, 2, 3, 5):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = tm.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("arch", ARCHS)
def test_tied_router_columns_route_as_the_reference(arch):
    """Experts 0 and 1 get the same router column (equal probabilities for
    every token), so the tie order decides the first choice, the priority
    and, at capacity factor 0.25, which tokens are dropped."""
    w = dict(_weights(arch))
    router = w["router"].copy()
    router[:, 1] = router[:, 0]
    w["router"] = router
    jcfg, _ = _cfgs(arch, "float32", moe_capacity_factor=0.25)
    x = _x(jcfg, 2, 16)
    top = np.argsort(-(x.reshape(-1, jcfg.d_model) @ router), -1, kind="stable")[:, 0]
    assert (top == 0).any()  # some first choices land on the tie
    got, want, _, _ = _run_both(arch, "float32", 2, 16, w=w, moe_capacity_factor=0.25)
    _check(got, want, "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_draws_the_reference_shapes_and_scales(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    ref = jax.eval_shape(lambda k: jm.init_moe(k, jcfg), jax.random.PRNGKey(0))
    m = tm.init_moe(tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    again = tm.init_moe(tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    d, f = tcfg.d_model, tcfg.expert_d_ff
    for name, scale in (("router", d ** -0.5), ("w1", d ** -0.5), ("w3", d ** -0.5),
                        ("w2", f ** -0.5)):
        p = getattr(m, name)
        assert tuple(p.shape) == tuple(ref[name].shape), name
        assert p.dtype == (torch.float32 if name == "router" else torch.bfloat16), name
        assert torch.equal(p, getattr(again, name)) and not p.requires_grad
        assert abs(float(p.float().std()) - scale) < 0.1 * scale, (name, float(p.float().std()))
    empty = tm.init_moe(tcfg, device="cpu")  # no generator: zeros, to be loaded
    assert not any(p.any() for p in empty.parameters())
