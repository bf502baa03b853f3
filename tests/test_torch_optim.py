"""The port's optimizers, schedule and error-feedback compression
(``repro_torch.optim``, ``repro_torch.distributed.compression``) against
the reference's, on the CPU.

On seeded trees — the reference's ``init_lm`` parameters of a SMOKE config
carried into the port (``lm_from_numpy(..., dtype="float32")``) and seeded
numpy gradients per leaf — three steps of AdamW and of Adafactor give the
parameters and every moment leaf (``OptState.tensors()`` against
``jax.tree.leaves(opt_state)``: the same leaves in the same order) within
1e-6; the port walks the reference's stacked leaves
(``param_leaves``), so Adafactor factors a stacked norm as the reference
does and clips by the whole stack's RMS.  ``cosine_warmup``,
``global_norm`` and ``clip_by_global_norm`` match within 1e-6;
``ef_compress`` equals the reference bit for bit step by step and keeps its
error-feedback property (``tests/test_distributed.py``'s case); and the
reference's ``tests/test_train.py`` optimizer cases are mirrored.
"""
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
from repro.distributed.compression import ef_compress as jax_ef_compress
from repro.distributed.compression import ef_init as jax_ef_init
from repro.models.lm import init_lm as jax_init_lm
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import cosine_warmup as jax_cosine
from repro.optim import global_norm as jax_global_norm
from repro.optim import make_optimizer as jax_make_optimizer
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.compression import ef_compress, ef_init, quantize_int8
from repro_torch.interop import lm_from_numpy, lm_to_numpy
from repro_torch.models.lm import param_leaves
from repro_torch.optim import (adafactor_init, adamw_init, clip_by_global_norm, cosine_warmup,
                               global_norm, make_optimizer)

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _tree(arch: str):
    """(reference params as numpy, the port's training model on them)."""
    params = jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(0), jax_smoke(arch)))
    return params, lm_from_numpy(get_smoke_config(arch), params, device="cpu", dtype="float32")


def _grads(seed: int, leaves):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=leaf.shape).astype(np.float32) for leaf in leaves]


def _three_steps(arch: str, name: str) -> None:
    """Three steps of both optimizers on the same seeded tree and gradients;
    raises unless parameters and moments agree within TOL.  Each framework
    gets its own copy of every gradient, and every reference step is waited
    for before the port's step runs: no host memory is shared with an
    asynchronous JAX computation."""
    params, model = _tree(arch)
    leaves = param_leaves(model)
    flat, tdef = jax.tree.flatten(params)
    assert [tuple(a.shape) for a in flat] == [leaf.shape for leaf in leaves]
    j_init, j_update = jax_make_optimizer(name)
    t_init, t_update = make_optimizer(name)
    jp, js = params, j_init(params)
    ts = t_init(leaves)
    for step in range(3):
        g = _grads(100 + step, leaves)
        lr = 1e-2 * (step + 1)
        jp, js = j_update(jax.tree.unflatten(tdef, [jnp.array(a, copy=True) for a in g]), js, jp,
                          jnp.float32(lr))
        jax.block_until_ready((jp, js))
        ts = t_update([torch.tensor(a) for a in g], ts, leaves, torch.tensor(lr))
    for a, b in zip(jax.tree.leaves(lm_to_numpy(model)), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    want = jax.tree.leaves(js)
    got = ts.tensors()
    assert len(got) == len(want) and int(got[0]) == int(want[0]) == 3
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


#: the comparison in a fresh interpreter, set up as the test run is
#: (float64 enabled in JAX as tests/conftest.py does; denormals flushed as
#: the autouse fixture does)
_CHILD = """
import sys
import jax
import torch
jax.config.update("jax_enable_x64", True)
torch.set_flush_denormal(True)
sys.path.insert(0, {tests!r})
import test_torch_optim
test_torch_optim._three_steps({arch!r}, {name!r})
print("OPTIM_OK")
"""


@pytest.mark.parametrize("arch,name", [("jamba-1.5-large-398b", "adamw"),
                                       ("jamba-1.5-large-398b", "adafactor"),
                                       ("mamba2-370m", "adafactor")])
def test_three_optimizer_steps_match_the_reference(arch, name):
    """Run in a fresh interpreter: in one whole-suite run (``-n 6 --dist
    loadfile``) the jamba AdamW case once differed from the reference by up
    to 3.0e-6 on 4.8 % of the ``embed/head`` leaf, which no later whole-suite
    run, no run after any one of the reference's test files and no run at
    1 or 6 torch threads reproduced; a fresh process keeps the comparison
    free of what a worker's earlier tests leave behind (thread pools and
    their floating-point state, JAX's dispatch queue)."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    res = subprocess.run(
        [sys.executable, "-c", _CHILD.format(tests=str(root / "tests"), arch=arch, name=name)],
        capture_output=True, text=True, timeout=900, env=env)
    assert res.returncode == 0 and "OPTIM_OK" in res.stdout, \
        (res.stdout[-4000:], res.stderr[-4000:])


@pytest.mark.parametrize("step", [0, 1, 9, 10, 11, 55, 100, 250])
def test_cosine_warmup_matches_the_reference(step):
    kw = dict(peak_lr=3e-4, warmup=10, total=100)
    got = cosine_warmup(torch.tensor(step, dtype=torch.int32), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(jax_cosine(jnp.int32(step), **kw)), rtol=1e-6)


def test_global_norm_and_clip_match_the_reference():
    rng = np.random.default_rng(3)
    tree = [rng.normal(size=s).astype(np.float32) * 4 for s in ((8,), (3, 5), (2, 3, 4))]
    jt = [jnp.asarray(a) for a in tree]
    tt = [torch.from_numpy(a) for a in tree]
    np.testing.assert_allclose(float(global_norm(tt)), float(jax_global_norm(jt)), rtol=1e-6)
    for max_norm in (1.0, 1e3):
        got, gn = clip_by_global_norm(tt, max_norm)
        want, wn = jax_clip(jt, max_norm)
        np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_schedule_and_clip():
    """The reference's ``tests/test_train.py::test_schedule_and_clip``."""
    assert float(cosine_warmup(0, peak_lr=1.0, warmup=10, total=100)) == pytest.approx(0.1)
    assert float(cosine_warmup(10, peak_lr=1.0, warmup=10, total=100)) == 1.0
    assert 0.09 < float(cosine_warmup(100, peak_lr=1.0, warmup=10, total=100)) < 0.11
    clipped, norm = clip_by_global_norm([torch.full((4,), 10.0)], 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(torch.linalg.norm(clipped[0])) == pytest.approx(1.0, rel=1e-4)


def test_adafactor_memory_is_sublinear():
    """The reference's ``test_adafactor_memory_is_sublinear`` on the port."""
    _, model = _tree("jamba-1.5-large-398b")
    leaves = param_leaves(model)
    adam, fact = adamw_init(leaves), adafactor_init(leaves)
    size = lambda ts: sum(t.numel() for t in ts)  # noqa: E731
    n_fact = size(fact.tensors()) - 1  # less the step
    assert n_fact < 0.25 * (size(adam.tensors()) - 1)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("sgd")


def test_error_feedback_matches_the_reference_and_recovers_the_sum():
    """``tests/test_distributed.py``'s EF case: 50 seeded gradients; each
    compressed gradient and carried error equals the reference's bit for
    bit, and compressed sum + carried error == the true sum."""
    rng = np.random.default_rng(0)
    grads = [rng.normal(size=(32,)).astype(np.float32) for _ in range(50)]
    state, jstate = ef_init([torch.from_numpy(grads[0])]), jax_ef_init(jnp.asarray(grads[0]))
    total_comp = np.zeros(32)
    for g in grads:
        (cg,), state = ef_compress([torch.from_numpy(g)], state)
        jcg, jstate = jax_ef_compress(jnp.asarray(g), jstate)
        np.testing.assert_array_equal(cg.numpy(), np.asarray(jcg))
        np.testing.assert_array_equal(state[0].numpy(), np.asarray(jstate))
        total_comp += cg.numpy()
    resid = np.abs(total_comp + state[0].numpy() - sum(grads)).max()
    assert resid < 1e-3


def test_compression_payload_is_4x_smaller():
    q, _ = quantize_int8(torch.zeros(1024))
    assert q.dtype == torch.int8 and q.numel() * q.element_size() * 4 == 1024 * 4


def test_the_leaves_are_the_reference_pytree_in_flatten_order():
    """``param_leaves`` walks the reference's pytree in ``jax.tree`` order,
    with stacked leaves (periods, encoder layers) as their parts."""
    for arch in ("qwen3-0.6b", "jamba-1.5-large-398b", "seamless-m4t-large-v2",
                 "llama-3.2-vision-11b"):
        params, model = _tree(arch)
        paths = [tuple(k.key for k in path)
                 for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
        leaves = param_leaves(model)
        assert [leaf.path for leaf in leaves] == paths
        cfg = get_smoke_config(arch)
        for leaf in leaves:
            if leaf.path[0] == "periods":
                assert leaf.stacked and len(leaf.parts) == cfg.n_periods
        assert sum(p.numel() for leaf in leaves for p in leaf.parts) == \
            sum(p.numel() for p in model.parameters())
