"""The port's GPipe ``pipeline_apply`` (``repro_torch.distributed.pipeline``)
on spawned gloo ranks, against the reference's.

The reference's script (``tests/test_distributed.py``'s ``_PIPE_SCRIPT``):
S 4 stages, M 8 microbatches of B 2 rows, D 16, stage ``tanh(h @ w)``; the
weights (S, D, D) * 0.3 and the input (M, B, D) are drawn with numpy from a
seed.  The reference's ``pipeline_apply`` runs in a subprocess on 4 forced
host devices (skipped with the reason where that emulation is unavailable,
as the reference test does); the port's runs on 4 gloo ranks with both
forms of ``stage_params`` — plain tensors with a leading dim of S (each
rank takes its row) and DTensors ``Shard(0)`` over ``pipe`` (each rank
holds its own stage).  The port's output is within 2e-5 of the reference's
and bit-equal across ranks.  In the same group: S 1 (a (4, 1) ``data`` x
``pipe`` mesh) against a plain loop over the stages, S 2 with M 3 (a
(2, 2) mesh: two pipes of two stages) likewise, and a DTensor that is not
``Shard(0)`` over ``pipe`` raises, and a gloo group stages CUDA tensors
through the host.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from test_torch_distributed import run_group

REPO = Path(__file__).resolve().parents[1]
S, M, B, D = 4, 8, 2, 16
TOL = 2e-5  # the reference test's rtol/atol


def _inputs(s: int = S, m: int = M, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((s, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((m, B, D)).astype(np.float32)
    return w, x


def _stage(w, h):
    return torch.tanh(h @ w)


def _loop(w: np.ndarray, x: np.ndarray) -> np.ndarray:
    h = torch.from_numpy(x)
    for s in range(w.shape[0]):
        h = _stage(torch.from_numpy(w[s]), h)
    return h.numpy()


_REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.distributed.pipeline import pipeline_apply
    d = np.load(sys.argv[1])
    mesh = jax.make_mesh((4,), ("pipe",))
    got = pipeline_apply(lambda w, h: jnp.tanh(h @ w), jnp.asarray(d["w"]),
                         jnp.asarray(d["x"]), mesh)
    np.save(sys.argv[2], np.asarray(got))
""")


def _reference(tmp_path: Path, w: np.ndarray, x: np.ndarray) -> np.ndarray:
    from conftest import multidevice_emulation_reason

    reason = multidevice_emulation_reason()
    if reason is not None:
        pytest.skip(f"multi-device emulation unavailable: {reason}")
    np.savez(tmp_path / "in.npz", w=w, x=x)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(tmp_path / "in.npz"),
                          str(tmp_path / "ref.npy")], capture_output=True, text=True,
                         env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return np.load(tmp_path / "ref.npy")


def _ranks(rank: int, world: int, w4, x8, w2, x3) -> dict:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed.pipeline import _transfer_device, pipeline_apply

    out = {}
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("pipe",))
    # gloo sends CPU tensors only: a CUDA (or meta) stage's transfers go through the host
    out["via"] = [str(_transfer_device(mesh.get_group(0), torch.device(d)))
                  for d in ("cpu", "cuda", "meta")]
    W, x = torch.from_numpy(w4), torch.from_numpy(x8)
    out["plain"] = pipeline_apply(_stage, W, x, mesh).numpy()
    # each rank holds only its own stage: local (1, D, D), Shard(0) over pipe
    local = W[rank:rank + 1].clone()
    Wd = DTensor.from_local(local, mesh, [Shard(0)], run_check=False)
    out["dtensor"] = pipeline_apply(lambda p, h: _stage(p["w"], h), {"w": Wd}, x, mesh).numpy()
    try:
        pipeline_apply(_stage, DTensor.from_local(W, mesh, [Replicate()], run_check=False),
                       x, mesh)
    except ValueError as e:
        out["replicated_error"] = str(e)
    one = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "pipe"))
    out["s1"] = pipeline_apply(_stage, W[:1], x, one).numpy()
    two = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "pipe"))
    out["s2"] = pipeline_apply(_stage, torch.from_numpy(w2), torch.from_numpy(x3), two).numpy()
    return out


@pytest.fixture(scope="module")
def group():
    w4, x8 = _inputs()
    w2, x3 = _inputs(2, 3, seed=1)
    return dict(w4=w4, x8=x8, w2=w2, x3=x3,
                res=run_group(4, _ranks, w4, x8, w2, x3))


@pytest.fixture(scope="module")
def reference(group, tmp_path_factory):
    return _reference(tmp_path_factory.mktemp("pipe"), group["w4"], group["x8"])


@pytest.mark.parametrize("form", ["plain", "dtensor"])
def test_four_stages_match_the_reference(group, reference, form):
    want = reference
    res = group["res"]
    assert res[0][form].shape == (M, B, D)
    np.testing.assert_allclose(res[0][form], want, rtol=TOL, atol=TOL)
    for r in res[1:]:
        np.testing.assert_array_equal(r[form], res[0][form])
    np.testing.assert_allclose(res[0][form], _loop(group["w4"], group["x8"]), rtol=TOL, atol=TOL)


def test_forms_agree_bit_for_bit(group):
    for r in group["res"]:
        np.testing.assert_array_equal(r["dtensor"], r["plain"])


@pytest.mark.parametrize("case", ["s1", "s2"])
def test_short_pipes_match_a_plain_loop(group, case):
    w, x = (group["w4"][:1], group["x8"]) if case == "s1" else (group["w2"], group["x3"])
    want = _loop(w, x)
    for r in group["res"]:
        assert r[case].shape == want.shape
        np.testing.assert_allclose(r[case], want, rtol=TOL, atol=TOL)


def test_gloo_transfers_go_through_the_host(group):
    for r in group["res"]:
        assert r["via"] == ["cpu", "cpu", "cpu"]


def test_a_stage_dtensor_must_shard_over_pipe(group):
    for r in group["res"]:
        assert "Shard(0) over 'pipe'" in r["replicated_error"]
