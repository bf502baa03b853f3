"""The port's serving path (repro_torch.serve.scheduler, repro_torch.launch.serve)
on the CPU.

* The port's ``ContinuousBatcher`` and the reference's, on the SMOKE configs
  of qwen3-0.6b, mamba2-370m, olmoe-1b-7b and jamba-1.5-large-398b (MoE in
  every layer, and attention + Mamba + MoE) with ``compute_dtype="float32"``
  and the same weights (the reference's ``init_lm`` pytree through
  ``lm_from_numpy``): prompts of 5, 9 and 7 tokens through 2 lanes
  (``tests/test_serving.py``'s stream) give equal greedy tokens, and equal
  one-request-at-a-time generation.  The idle lane of a tick routes through
  the experts and takes capacity, in both.
* Scheduler accounting: ``stats()``, the serve spans and counters, a
  validated Chrome trace, FIFO admission and lane reuse — the reference's
  own checks, on the port's ``TraceRecorder``.
* The launcher: ``python -m repro_torch.launch.serve --smoke --device cpu``,
  also for llama-3.2-vision-11b and seamless-m4t-large-v2, which it hands
  context embeddings.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_smoke
from repro.models.lm import init_lm as jax_init_lm
from repro.serve.scheduler import ContinuousBatcher as JaxBatcher
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.configs import get_smoke_config
from repro_torch.core.cfa.obs import TraceRecorder, validate_chrome_trace
from repro_torch.interop import lm_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.models.lm import init_lm, lm_decode, lm_prefill
from repro_torch.serve.scheduler import ContinuousBatcher, Request

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-0.6b", "mamba2-370m", "olmoe-1b-7b", "jamba-1.5-large-398b"]
PROMPT_LENS, N_NEW = (5, 9, 7), (4, 3, 5)  # tests/test_serving.py's stream


@pytest.fixture(autouse=True)
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)  # torch's default


@functools.lru_cache(maxsize=None)
def _f32_smoke(arch: str):
    """(jax cfg, numpy params, port model) with float32 compute."""
    jcfg = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    params = jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(0), jcfg))
    return jcfg, params, lm_from_numpy(tcfg, params, device="cpu")


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in PROMPT_LENS]


def _drain(batcher, request_cls, prompts, n_new):
    reqs = [request_cls(i, p, k) for i, (p, k) in enumerate(zip(prompts, n_new))]
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    return reqs


def _greedy_one(model, prompt, n_new, max_seq):
    logits, caches = lm_prefill(model, torch.from_numpy(prompt)[None], max_seq=max_seq)
    toks = [int(torch.argmax(logits[0, :model.cfg.vocab]))]
    for pos in range(len(prompt), len(prompt) + n_new - 1):
        logits, caches = lm_decode(model, caches, torch.tensor([toks[-1]]), pos)
        toks.append(int(torch.argmax(logits[0, :model.cfg.vocab])))
    return toks


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_the_reference_batcher(arch):
    jcfg, params, model = _f32_smoke(arch)
    prompts = _prompts(jcfg.vocab)
    want = _drain(JaxBatcher(jcfg, jax.tree.map(jnp.asarray, params), lanes=2, max_seq=32),
                  JaxRequest, prompts, N_NEW)
    got = _drain(ContinuousBatcher(model, lanes=2, max_seq=32), Request, prompts, N_NEW)
    for g, w, k in zip(got, want, N_NEW):
        assert g.done and len(g.out) == k
        assert g.out == w.out, (g.rid, g.out, w.out)


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_batching_matches_single_request(arch):
    """Mixed-length requests through 2 lanes == one-at-a-time generation."""
    jcfg, _, model = _f32_smoke(arch)
    prompts = _prompts(jcfg.vocab)
    reqs = _drain(ContinuousBatcher(model, lanes=2, max_seq=32), Request, prompts, N_NEW)
    for r, p, k in zip(reqs, prompts, N_NEW):
        assert r.out == _greedy_one(model, p, k, 32), r.rid


def test_per_lane_positions_match_scalar():
    """(B,) positions with equal values == scalar position decode."""
    _, _, model = _f32_smoke("qwen3-0.6b")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 512, size=(2, 12)))
    _, c1 = lm_prefill(model, tokens, max_seq=32)
    _, c2 = lm_prefill(model, tokens, max_seq=32)
    nxt = torch.tensor([3, 7])
    l_scalar, _ = lm_decode(model, c1, nxt, 12)
    l_vector, _ = lm_decode(model, c2, nxt, np.array([12, 12]))
    torch.testing.assert_close(l_scalar, l_vector, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# tick accounting + serve spans (a synthetic request stream through 2 lanes)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _smoke_model():
    cfg = get_smoke_config("qwen3-0.6b")
    return init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")


def _drained_batcher(*, recorder=None, lanes=2):
    model = _smoke_model()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, model.cfg.vocab, size=n).astype(np.int32) for n in (4, 6, 5, 3)]
    cb = ContinuousBatcher(model, lanes=lanes, max_seq=32, recorder=recorder)
    return cb, _drain(cb, Request, prompts, [3, 2, 4, 2])


def test_tick_accounting_totals():
    """stats() counts exactly the tokens decode ticks produced (admission
    emits the first token outside of step's live count)."""
    cb, reqs = _drained_batcher()
    st = cb.stats()
    assert st["tokens"] == sum(len(r.out) for r in reqs) - len(reqs)
    assert st["ticks"] >= max(k - 1 for k in (3, 2, 4, 2))
    assert st["tokens_per_sec"] > 0.0 and st["elapsed_s"] > 0.0
    assert st["occupancy"] == 0.0 and st["queue_depth"] == 0


def test_serve_spans_and_counters():
    """admit/retire/step spans land on the serve track and the counters
    reconcile with the request stream; the Chrome trace validates."""
    rec = TraceRecorder(label="serve-test")
    cb, reqs = _drained_batcher(recorder=rec)
    admits = rec.find("admit", cat="serve")
    retires = rec.find("retire", cat="serve")
    steps = rec.find("step", cat="serve")
    assert len(admits) == len(reqs) == rec.counters["serve_admitted"]
    assert len(retires) == len(reqs) == rec.counters["serve_retired"]
    assert {s.arg("rid") for s in admits} == {r.rid for r in reqs}
    assert {s.arg("rid") for s in retires} == {r.rid for r in reqs}
    assert len(steps) == cb.ticks == rec.counters["serve_ticks"]
    assert rec.counters["serve_tokens"] == cb.tokens
    occ = [s.arg("occupancy") for s in steps]
    assert all(0 <= o <= cb.lanes for o in occ) and sum(occ) == cb.tokens
    assert [v for _, n, v in rec.counter_samples if n == "occupancy"] == occ
    assert validate_chrome_trace(rec.to_chrome()) == []


def test_admit_retire_ordering():
    """A lane's retire precedes the admit that reuses it; FIFO admission."""
    rec = TraceRecorder(label="serve-order")
    _drained_batcher(recorder=rec)
    busy: dict[int, int] = {}
    admit_rids = []
    for s in rec.spans:
        if s.cat != "serve" or s.name not in ("admit", "retire"):
            continue
        lane = s.arg("lane")
        if s.name == "admit":
            assert lane not in busy, (lane, busy)
            busy[lane] = s.arg("rid")
            admit_rids.append(s.arg("rid"))
        else:
            assert busy.pop(lane) == s.arg("rid")
    assert not busy and admit_rids == sorted(admit_rids)


def test_a_lane_retires_at_the_cache_capacity():
    """A request that would outgrow max_seq stops at max_seq - 1 positions."""
    model = _smoke_model()
    cb = ContinuousBatcher(model, lanes=1, max_seq=12)
    req = Request(0, np.arange(8, dtype=np.int32), 100)
    cb.submit(req)
    cb.run()
    assert req.done and len(req.out) == 1 + (12 - 1 - 8)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,extra", [("qwen3-0.6b", []),
                                        ("mamba2-370m", ["--temperature", "0.8", "--top-k", "5"]),
                                        ("llama-3.2-vision-11b", []),
                                        ("seamless-m4t-large-v2", [])])
def test_launcher_runs_the_smoke_config_on_the_cpu(arch, extra):
    out = launcher.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                         "--prompt-len", "6", "--gen", "4", *extra])
    assert out["tokens"].shape == (2, 4)
    assert ((0 <= out["tokens"]) & (out["tokens"] < 512)).all()


def test_launcher_module_entry_point():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen3-0.6b", "--smoke",
         "--device", "cpu", "--batch", "1", "--prompt-len", "4", "--gen", "3"],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "decode: 1x3 tokens" in res.stdout
