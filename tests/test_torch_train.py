"""The port's training path (``repro_torch.train``, ``launch.train``, the
differentiable ``lm_forward``) against the reference's, on the CPU, where
``ssd_scan`` differentiates through its plain version.

* ``loss_fn``'s value and every gradient leaf against
  ``jax.value_and_grad(repro.train.steps.loss_fn)`` in float32 compute, with
  remat off and on (and the ``"dots"`` policy), on the SMOKE configs of
  qwen3-0.6b, mamba2-370m, olmoe-1b-7b (aux loss), llama-3.2-vision-11b (a
  context; the cross gate at 0.5) and seamless-m4t-large-v2 (the encoder):
  the loss within 1e-5 relative, each leaf within 1e-4 max|g_ref| + 1e-7.
  The reference's parameters cross over with ``lm_from_numpy(...,
  dtype="float32")`` and its gradients are compared leaf by leaf
  (``param_leaves`` is its flatten order).
* One ``make_train_step`` step against the reference's (AdamW on qwen3 and
  mamba2, Adafactor on jamba's SMOKE, ``accum=2``, ``compress_grads``):
  parameters and moments within the reference's own SPMD bound (rtol 2e-3,
  atol 3e-4, ``tests/test_distributed.py``); since a step moves a parameter
  by about lr = 3e-4, also each leaf's step within 1e-2 of the reference's
  in relative L2 norm, and each moment within 1e-4 (first) or 2e-4 (second)
  of its own max|.|; ``loss``, ``grad_norm`` and ``lr`` within 1e-5.
* The reference's ``tests/test_train.py`` Trainer cases mirrored on the
  port: loss falls on learnable data, a restart resumes bit for bit on the
  CPU, preemption, accumulation equivalence; ``launch.train.main`` for 3
  steps and again to resume; serving models keep frozen compute-dtype
  parameters.
"""
import dataclasses
import functools

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_smoke
from repro.models.lm import init_lm as jax_init_lm
from repro.optim import make_optimizer as jax_make_optimizer
from repro.train.steps import TrainHParams as JaxHParams
from repro.train.steps import loss_fn as jax_loss_fn
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticTokens
from repro_torch.interop import lm_from_numpy, lm_to_numpy
from repro_torch.launch import train as launch_train
from repro_torch.models.lm import init_lm, param_leaves
from repro_torch.optim import make_optimizer
from repro_torch.train.loop import Trainer
from repro_torch.train.steps import TrainHParams, loss_fn, make_train_step

GATE = 0.5  # the cross layers' gate in the compared weights (the reference's init is 0)
GRAD_TOL = (1e-4, 1e-7)  # (relative to max|g_ref| of the leaf, absolute)
STEP_TOL = dict(rtol=2e-3, atol=3e-4)  # tests/test_distributed.py's SPMD bound
#: each leaf's step (after minus before) in relative L2 norm: a skipped or
#: misrouted update is off by about 1, while AdamW's first step normalises
#: each gradient element by |g| + 1e-8, which the few elements near 1e-8
#: turn into O(1) per-element differences (9.0e-4 at most in these cases)
DELTA_TOL = 1e-2
#: the moments against their own max|.|: the first is linear in the gradient
#: (GRAD_TOL's 1e-4), the second quadratic (twice that)
MOMENT_TOL = (1e-4, 2e-4)


@pytest.fixture(autouse=True)
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _cfgs(arch: str, **kw):
    base = {"qwen3-0.6b": dict(n_layers=2)}.get(arch, {})
    over = dict(base, compute_dtype="float32", **kw)
    return (dataclasses.replace(jax_smoke(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over))


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    jcfg, _ = _cfgs(arch)
    params = jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(0), jcfg))
    for i, kind in enumerate(jcfg.period):
        if kind == "cross":
            pos = params["periods"][f"pos{i}"]
            pos["gate"] = np.full_like(pos["gate"], GATE)
    return params


def _batch(cfg, B: int = 2, S: int = 16, seed: int = 1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)}
    if cfg.family in ("vlm", "encdec"):
        batch["context"] = (rng.normal(size=(B, cfg.n_context_tokens, cfg.d_model))
                            * 0.02).astype(np.float32)
    return batch


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


LOSS_CASES = [(arch, remat, None) for arch in ("qwen3-0.6b", "mamba2-370m", "olmoe-1b-7b",
                                                "llama-3.2-vision-11b", "seamless-m4t-large-v2")
              for remat in (False, True)] + [("qwen3-0.6b", True, "dots"),
                                             ("mamba2-370m", True, "dots")]


@pytest.mark.parametrize("arch,remat,policy", LOSS_CASES)
def test_loss_value_and_gradients_match_the_reference(arch, remat, policy):
    jcfg, tcfg = _cfgs(arch)
    params = _params(arch)
    batch = _batch(jcfg)
    jhp = JaxHParams(remat=remat, remat_policy=policy or "none")
    thp = TrainHParams(remat=remat, remat_policy=policy or "none")
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        functools.partial(jax_loss_fn, cfg=jcfg, hp=jhp), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = lm_from_numpy(tcfg, params, device="cpu", dtype="float32")
    loss, m = loss_fn(model, _port_batch(batch), tcfg, thp)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), rtol=1e-5, atol=1e-7)
    if tcfg.moe_experts:
        assert float(m["aux"]) > 0
    leaves = param_leaves(model)
    want = jax.tree.leaves(jgrads)
    assert len(leaves) == len(want)
    for leaf, w in zip(leaves, want):
        g, w = leaf.take_grad().double().numpy(), np.asarray(w, np.float64)
        err = np.abs(g - w).max()
        assert err <= GRAD_TOL[0] * np.abs(w).max() + GRAD_TOL[1], (leaf.path, err)


STEP_CASES = [("qwen3-0.6b", {}), ("mamba2-370m", {}), ("jamba-1.5-large-398b", {}),
              ("qwen3-0.6b", {"accum": 2}), ("mamba2-370m", {"compress_grads": True})]


@pytest.mark.parametrize("arch,extra", STEP_CASES)
def test_one_train_step_matches_the_reference(arch, extra):
    jcfg, tcfg = _cfgs(arch)
    assert tcfg.optimizer == ("adafactor" if arch.startswith("jamba") else "adamw")
    params = _params(arch)
    batch = _batch(jcfg, B=4)
    kw = dict(remat=False, warmup=1, **extra)
    jp, jo, jm = jax.jit(jax_make_train_step(jcfg, JaxHParams(**kw)))(
        params, jax_make_optimizer(jcfg.optimizer)[0](params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    model = lm_from_numpy(tcfg, params, device="cpu", dtype="float32")
    opt = make_optimizer(tcfg.optimizer)[0](param_leaves(model))
    _, opt, tm = make_train_step(tcfg, TrainHParams(**kw))(model, opt, _port_batch(batch))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    for a0, a, b in zip(jax.tree.leaves(params), jax.tree.leaves(lm_to_numpy(model)),
                        jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), **STEP_TOL)
        # the step itself, which is about lr in size and so below STEP_TOL's atol
        a0 = np.asarray(a0, np.float64)
        d_got, d_want = np.asarray(a, np.float64) - a0, np.asarray(b, np.float64) - a0
        assert np.linalg.norm(d_want) > 0
        assert np.linalg.norm(d_got - d_want) <= DELTA_TOL * np.linalg.norm(d_want)
    got, want = opt.tensors(), jax.tree.leaves(jo)
    assert len(got) == len(want) and int(got[0]) == int(want[0]) == 1
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **STEP_TOL)
        a, b = a.double().numpy(), np.asarray(b, np.float64)
        rel = MOMENT_TOL[0] if i <= len(opt.mu) else MOMENT_TOL[1]
        assert np.abs(a - b).max() <= rel * np.abs(b).max(), (i, np.abs(a - b).max())


def _small():
    return dataclasses.replace(get_smoke_config("qwen3-0.6b"), n_layers=2)


def test_loss_decreases_on_learnable_data(tmp_path):
    """Train on a tiny fixed dataset the model can memorise."""
    cfg = _small()

    class Fixed(SyntheticTokens):
        def batch_at(self, step):
            rng = np.random.default_rng(42)  # same batch every step
            return {"tokens": rng.integers(0, self.vocab, size=(self.batch, self.seq),
                                           dtype=np.int32)}

    hp = TrainHParams(peak_lr=1e-2, warmup=2, total_steps=40, remat=False)
    tr = Trainer(cfg, batch=4, seq=32, ckpt_dir=tmp_path, hp=hp,
                 data=Fixed(vocab=cfg.vocab, batch=4, seq=32), ckpt_every=1000, device="cpu")
    log = tr.run(30, log_every=1)
    assert log[-1]["loss"] < log[0]["loss"] * 0.7, (log[0]["loss"], log[-1]["loss"])
    assert all(np.isfinite(m["grad_norm"]) for m in log)
    tr.data.close()


def test_checkpoint_restart_resumes_identically(tmp_path):
    """The reference's case, held bit for bit on the CPU: losses, the
    parameters and every optimizer tensor of the resumed run equal the
    uninterrupted run's."""
    cfg = _small()
    hp = TrainHParams(remat=False, warmup=2, total_steps=50)
    kw = dict(batch=2, seq=16, hp=hp, ckpt_every=5, seed=3, device="cpu")
    tr1 = Trainer(cfg, ckpt_dir=tmp_path / "a", **kw)
    tr1.run(10, log_every=1)
    tr1.data.close()
    tr2 = Trainer(cfg, ckpt_dir=tmp_path / "b", **kw)
    tr2.run(5, log_every=1)
    tr2.data.close()
    tr3 = Trainer(cfg, ckpt_dir=tmp_path / "b", **kw)
    assert tr3.step == 5  # restored
    tr3.run(5, log_every=1)
    tr3.data.close()
    assert [m["loss"] for m in tr3.metrics_log] == [m["loss"] for m in tr1.metrics_log[5:]]
    assert all(torch.equal(a, b) for a, b in zip(tr3.state(), tr1.state()))


def test_preemption_checkpoint(tmp_path):
    tr = Trainer(_small(), batch=2, seq=16, ckpt_dir=tmp_path, hp=TrainHParams(remat=False),
                 ckpt_every=1000, seed=1, device="cpu")
    (tr.ckpt.dir / "PREEMPT").write_text("")
    tr.run(10, log_every=1)
    assert tr.step == 1  # stopped after the first step
    assert tr.ckpt.latest_step() == 1  # and checkpointed before exiting
    tr.data.close()


def test_grad_accumulation_equivalence():
    """accum=2 == accum=1 on the same global batch (the reference's limits)."""
    cfg = dataclasses.replace(_small(), compute_dtype="float32")
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, size=(4, 16)).astype(np.int32))}
    outs = {}
    for accum in (1, 2):
        model = init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                        dtype=cfg.param_dtype)
        opt = make_optimizer(cfg.optimizer)[0](param_leaves(model))
        _, _, m = make_train_step(cfg, TrainHParams(remat=False, accum=accum, warmup=1))(
            model, opt, batch)
        outs[accum] = (jax.tree.leaves(lm_to_numpy(model)), float(m["loss"]))
    np.testing.assert_allclose(outs[1][1], outs[2][1], rtol=1e-5)
    for a, b in zip(outs[1][0], outs[2][0]):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5)


def test_launcher_trains_and_resumes(tmp_path, capsys):
    argv = ["--arch", "mamba2-370m", "--smoke", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3",
            "--log-every", "1"]
    first = launch_train.main(argv)
    assert first["start"] == 0 and [m["step"] for m in first["log"]] == [1, 2, 3]
    second = launch_train.main(argv)
    assert second["start"] == 3 and [m["step"] for m in second["log"]] == [4, 5, 6]
    assert all(np.isfinite(m["loss"]) for m in first["log"] + second["log"])
    out = capsys.readouterr().out
    assert "ran 3 steps (resumed from 0)" in out and "ran 3 steps (resumed from 3)" in out
    with pytest.raises(RuntimeError, match="process group"):  # the pods need torchrun
        launch_train.main(argv + ["--multi-pod"])


def test_serving_models_keep_frozen_compute_dtype_parameters():
    cfg = get_smoke_config("mamba2-370m")
    serve = init_lm(cfg, device="cpu")
    train = init_lm(cfg, device="cpu", dtype=cfg.param_dtype)
    assert not any(p.requires_grad for p in serve.parameters())
    assert serve.layers[0].mixer.w_x.dtype == torch.bfloat16
    assert serve.layers[0].mixer.A_log.dtype == torch.float32
    assert all(p.requires_grad and p.dtype == torch.float32 for p in train.parameters())
    # the same draws: a serving model's matrices are the training model's, rounded
    assert torch.equal(serve.layers[0].mixer.w_x, train.layers[0].mixer.w_x.bfloat16())


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-370m", "olmoe-1b-7b",
                                  "llama-3.2-vision-11b", "seamless-m4t-large-v2",
                                  "jamba-1.5-large-398b"])
def test_lm_to_numpy_round_trips_bit_for_bit(arch):
    """The reference's pytree -> ``lm_from_numpy(dtype=float32)`` ->
    ``lm_to_numpy``: the same structure, dtypes and bits; a serving model
    gives the leaves rounded to its compute dtype."""
    _, tcfg = _cfgs(arch)
    params = _params(arch)
    back = lm_to_numpy(lm_from_numpy(tcfg, params, device="cpu", dtype="float32"))
    want, tdef = jax.tree.flatten(params)
    got, tdef2 = jax.tree.flatten(back)
    assert tdef == tdef2
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    serve_cfg = dataclasses.replace(tcfg, compute_dtype="bfloat16")
    served = jax.tree.leaves(lm_to_numpy(lm_from_numpy(serve_cfg, params, device="cpu")))
    rounded = 0
    for a, b in zip(served, want):
        b16 = np.asarray(jnp.asarray(b, jnp.bfloat16).astype(jnp.float32))
        assert np.array_equal(a, b) or np.array_equal(a, b16)  # float32 leaf or matrix
        rounded += not np.array_equal(a, b)
    assert rounded > 0
