"""The port's sharded train step (``repro_torch.train.steps`` under a mesh,
``repro_torch.models.lm.shard_lm``) on 8 gloo ranks of one spawned group,
a 4 x 2 ("data", "model") mesh, against single-device steps.

The reference's SPMD script (``tests/test_distributed.py``): qwen3 SMOKE, 2
layers, float32 compute, ``remat=False``, ``warmup=1``, tokens (8, 32)
from a seed, the reference's ``init_lm`` weights carried across.  The
sharded step is held against the port's single-device step (loss rtol
1e-6, every parameter rtol 1e-5 / atol 1e-6: the same arithmetic, sums in
another order) and against the reference's single-device step, run here in
the pytest process, within the reference's own limits (loss rtol 1e-4,
parameters rtol 2e-3 / atol 3e-4) — for ``shard_grads`` on and off and
``accum=2``.  The reference's own sharded step raises on this host, so its
single-device step is the oracle.  In the same group: Adafactor (its
factored moments reduce across ranks), mamba2 SMOKE with remat (the SSD's
plain version; the gathers rerun in the recompute) and olmoe SMOKE (the
MoE aux loss over the global batch, capacity groups that each lie on one
rank) against the port's single-device step; a capacity group that would
span ranks raises.  Also: the placements of the sharded parameters and
moments; ``named`` placements whose ``distribute_tensor`` round-trips to
the reference's blocks; ``constrain`` under a policy that folds ``model``
into the batch; the SSD wrappers refuse a DTensor; the production meshes
refuse a world that is not theirs.

The ranks run in one group spawned once for the file (``run_group``, also
used by ``test_torch_elastic.py``); where ranks cannot be spawned or the
gloo group cannot start, the tests skip with the reason.
"""
import dataclasses
import datetime
import os
import pickle
import tempfile
import time
import traceback

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import torch.multiprocessing as mp

from repro_torch.configs import get_smoke_config
from repro_torch.interop import lm_from_numpy, lm_to_numpy
from repro_torch.models.lm import init_lm, param_leaves
from repro_torch.optim import make_optimizer
from repro_torch.train.steps import TrainHParams, make_train_step

WORLD, MESH = 8, (4, 2)
PORT_LOSS_RTOL, PORT_TOL = 1e-6, dict(rtol=1e-5, atol=1e-6)
REF_LOSS_RTOL, REF_TOL = 1e-4, dict(rtol=2e-3, atol=3e-4)  # tests/test_distributed.py's
GROUP_TIMEOUT_S = 240


# ---------------------------------------------------------------------------
# the spawned group (shared with test_torch_elastic.py)
# ---------------------------------------------------------------------------

def _rank(rank: int, world: int, store: str, out: str, fn, args) -> None:
    """One rank: start the gloo group, run ``fn(rank, world, *args)``, write
    its result (or the traceback) for the parent."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=90))
    except Exception as e:  # the environment, not the port: the parent skips
        payload = {"skip": f"the gloo group did not start: {e!r}"}
    else:
        try:
            payload = {"ok": fn(rank, world, *args)}
        except Exception:
            payload = {"error": traceback.format_exc()}
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(payload, f)


def run_group(world: int, fn, *args, timeout: float = GROUP_TIMEOUT_S) -> list:
    """``fn(rank, world, *args)`` on ``world`` spawned gloo ranks; the
    ranks' results in rank order.  Skips where ranks cannot be spawned or
    the group cannot start; fails on a rank's exception or the timeout."""
    out = tempfile.mkdtemp(prefix="ranks_")
    store = os.path.join(out, "store")
    try:
        ctx = mp.start_processes(_rank, args=(world, store, out, fn, args), nprocs=world,
                                 join=False, start_method="spawn")
    except (OSError, RuntimeError) as e:
        pytest.skip(f"cannot spawn {world} ranks here: {e!r}")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {world}-rank group did not finish in {timeout} s")
    payloads = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            payloads.append(pickle.load(f))
    skips = [p["skip"] for p in payloads if "skip" in p]
    if skips:
        pytest.skip(skips[0])
    errors = [f"rank {r}:\n{p['error']}" for r, p in enumerate(payloads) if "error" in p]
    assert not errors, "\n".join(errors)
    return [p["ok"] for p in payloads]


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

REF_CASES = {  # held against the reference's single-device step too
    "qwen3-shard-grads": dict(arch="qwen3-0.6b", hp=dict(shard_grads=True)),
    "qwen3-replicated-grads": dict(arch="qwen3-0.6b", hp=dict(shard_grads=False)),
    "qwen3-accum2": dict(arch="qwen3-0.6b", hp=dict(accum=2)),
}
PORT_CASES = {
    "qwen3-adafactor": dict(arch="qwen3-0.6b", cfg=dict(optimizer="adafactor"), hp={}),
    "mamba2-remat": dict(arch="mamba2-370m", hp=dict(remat=True)),
    "olmoe": dict(arch="olmoe-1b-7b", hp={}),
}
#: a rank's 2 x 8 tokens against olmoe SMOKE's routing groups of 32
SPAN_CASE = dict(arch="olmoe-1b-7b", hp={}, tokens=(8, 8))
CASES = {**REF_CASES, **PORT_CASES, "olmoe-span": SPAN_CASE}


def _cfg(case: dict):
    cfg = get_smoke_config(case["arch"])
    over = dict(compute_dtype="float32", **case.get("cfg", {}))
    if case["arch"] == "qwen3-0.6b":
        over["n_layers"] = 2
    return dataclasses.replace(cfg, **over)


def _hp(case: dict) -> TrainHParams:
    return TrainHParams(**{"remat": False, "warmup": 1, **case["hp"]})


def _tokens(case: dict) -> np.ndarray:
    cfg = _cfg(case)
    shape = case.get("tokens", (8, 32))
    return np.random.default_rng(1).integers(0, cfg.vocab, size=shape).astype(np.int32)


def _weights(name: str, case: dict, ref_params: dict):
    """A float32 training model on the CPU: the reference's ``init_lm``
    weights for the REF_CASES, the port's seeded draw for the others."""
    cfg = _cfg(case)
    if name in REF_CASES:
        return lm_from_numpy(cfg, ref_params, device="cpu", dtype="float32")
    return init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                   dtype="float32")


def _flat(tree) -> list:
    """A nested dict's leaves in sorted-key order (``jax.tree.leaves``')."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


def _step(model, case: dict, tokens: np.ndarray) -> dict:
    cfg = _cfg(case)
    opt = make_optimizer(cfg.optimizer)[0](param_leaves(model))
    _, opt, m = make_train_step(cfg, _hp(case))(model, opt, {"tokens": torch.from_numpy(tokens)})
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": _flat(lm_to_numpy(model)), "opt": opt}


def _describe(t) -> str:
    return repr(tuple(getattr(t, "placements", ())))


def _group_cases(rank: int, world: int, inputs: str) -> dict | None:
    """Every case's sharded step on a 4 x 2 mesh, and the placement checks;
    rank 0's view returned."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.distributed.sharding import P, constrain, named, use_mesh
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.launch.mesh import make_production_mesh, mesh_for_devices
    from repro_torch.models.lm import shard_lm

    with open(inputs, "rb") as f:
        ref_params = pickle.load(f)
    mesh = mesh_for_devices(model=MESH[1], device="cpu")
    out: dict = {}
    for name, case in CASES.items():
        model = shard_lm(_weights(name, case, ref_params), mesh)
        try:
            with use_mesh(mesh):
                res = _step(model, case, _tokens(case))
        except ValueError as e:
            out[name] = {"error": str(e)}
            continue
        leaves = param_leaves(model)
        res["placements"] = {"/".join(lf.path): (_describe(lf.parts[0]), _describe(mu))
                             for lf, mu in zip(leaves, res["opt"].mu)}
        res["nu"] = [{k: _describe(t) for k, t in v.items()} if isinstance(v, dict)
                     else _describe(v) for v in res["opt"].nu]
        del res["opt"]
        out[name] = res
    # named -> distribute_tensor round-trips, with the reference's blocks
    coord = mesh.get_coordinate()
    t = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    blocks = {
        "P('data','model')": (P("data", "model"), t[2 * coord[0]:2 * coord[0] + 2,
                                                   3 * coord[1]:3 * coord[1] + 3]),
        "P(('data','model'))": (P(("data", "model")), t[coord[0] * 2 + coord[1]:][:1]),
        "P(None,'model','data')": (P(None, "model", "data"),
                                   t[:, 3 * coord[1]:3 * coord[1] + 3, coord[0]:coord[0] + 1]),
    }
    trips = {}
    for key, (spec, want) in blocks.items():
        dt = distribute_tensor(t, mesh, named(spec, t.shape, mesh))
        trips[key] = bool(torch.equal(dt.to_local(), want) and torch.equal(dt.full_tensor(), t))
    out["round_trip"] = trips
    # constrain: the batch over ("data", "model") (8 ways), from a plain tensor
    # and from a DTensor; against the mesh's order it raises
    with use_mesh(mesh, dp_axes=("data", "model")):
        from repro_torch.distributed.sharding import batch_spec

        c = constrain(t, batch_spec(None, None))
        c2 = constrain(distribute_tensor(t, mesh, [Replicate(), Replicate()]), batch_spec())
        out["constrain"] = (tuple(c.placements), bool(torch.equal(c.to_local(), t[rank:rank + 1])),
                            tuple(c2.placements), bool(torch.equal(c2.full_tensor(), t)))
    with use_mesh(mesh, dp_axes=("model", "data")):
        try:
            constrain(t, batch_spec())
            out["against_order"] = None
        except ValueError as e:
            out["against_order"] = str(e)
    out["expected_placements"] = (Shard(0), Shard(0))
    # the SSD wrappers take no DTensor
    x = distribute_tensor(torch.zeros(1, 8, 2, 4), mesh, [Replicate(), Replicate()])
    try:
        ssd_scan(x, torch.zeros(1, 8, 2), torch.zeros(1, 8, 4), torch.zeros(1, 8, 4), chunk=8)
        out["ssd_dtensor"] = None
    except TypeError as e:
        out["ssd_dtensor"] = str(e)
    # the production meshes need their own world size
    msgs = []
    for multi_pod in (False, True):
        try:
            make_production_mesh(multi_pod=multi_pod, device="cpu")
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    out["production"] = msgs
    out["dtensor_params"] = isinstance(param_leaves(model)[0].parts[0], DTensor)
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def group():
    """Rank 0's results of the 8-rank group, and the inputs it was given."""
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.models.lm import init_lm as jax_init_lm

    jcfg = dataclasses.replace(jax_smoke("qwen3-0.6b"), n_layers=2, compute_dtype="float32")
    ref_params = jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(0), jcfg))
    path = os.path.join(tempfile.mkdtemp(prefix="inputs_"), "ref_params.pkl")
    with open(path, "wb") as f:
        pickle.dump(ref_params, f)
    return run_group(WORLD, _group_cases, path)[0], ref_params


def _single(name: str, ref_params: dict) -> dict:
    case = CASES[name]
    return _step(_weights(name, case, ref_params), case, _tokens(case))


def _close_params(got: list, want: list, tol: dict) -> None:
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("name", list(REF_CASES) + list(PORT_CASES))
def test_sharded_step_matches_the_ports_single_device_step(group, name):
    res, ref_params = group
    got, want = res[name], _single(name, ref_params)
    assert "error" not in got, got.get("error")
    for k, v in want["metrics"].items():
        rtol = PORT_LOSS_RTOL if k in ("loss", "ce") else PORT_TOL["rtol"]
        np.testing.assert_allclose(got["metrics"][k], v, rtol=rtol, atol=1e-9, err_msg=k)
    if name == "olmoe":
        assert got["metrics"]["aux"] > 0
    _close_params(got["params"], want["params"], PORT_TOL)


@pytest.mark.parametrize("name", list(REF_CASES))
def test_sharded_step_matches_the_references_single_device_step(group, name):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke
    from repro.optim import make_optimizer as jax_make_optimizer
    from repro.train.steps import TrainHParams as JaxHParams
    from repro.train.steps import make_train_step as jax_make_train_step

    res, ref_params = group
    case = REF_CASES[name]
    jcfg = dataclasses.replace(jax_smoke("qwen3-0.6b"), n_layers=2, compute_dtype="float32")
    jhp = JaxHParams(**{"remat": False, "warmup": 1, **case["hp"]})
    opt = jax_make_optimizer(jcfg.optimizer)[0](ref_params)
    p1, _, m1 = jax.jit(jax_make_train_step(jcfg, jhp))(
        ref_params, opt, {"tokens": jnp.asarray(_tokens(case))})
    got = res[name]
    np.testing.assert_allclose(got["metrics"]["loss"], float(m1["loss"]), rtol=REF_LOSS_RTOL)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], float(m1["grad_norm"]),
                               rtol=REF_LOSS_RTOL)
    _close_params(got["params"], [np.asarray(a, np.float32) for a in jax.tree.leaves(p1)],
                  REF_TOL)


def test_a_capacity_group_that_would_span_ranks_raises(group):
    res, _ = group
    assert "span ranks" in res["olmoe-span"]["error"]
    # on one device the same batch routes as the reference does
    assert np.isfinite(_single("olmoe-span", None)["metrics"]["aux"])


def test_parameters_and_moments_are_placed_by_the_specs(group):
    """FSDP over data and TP over model, as the spec tree says (qwen3 SMOKE
    on 4 x 2): a stacked leaf's part takes its spec without the period axis,
    its AdamW moments the whole spec; Adafactor's factored moments drop the
    reduced dim's axis."""
    res, _ = group
    pl = res["qwen3-shard-grads"]["placements"]
    assert pl["periods/pos0/mixer/wq"] == ("(Shard(dim=0), Shard(dim=1))",
                                           "(Shard(dim=1), Shard(dim=2))")
    assert pl["periods/pos0/mixer/wo"] == ("(Shard(dim=2), Shard(dim=0))",
                                           "(Shard(dim=3), Shard(dim=1))")
    assert pl["embed/table"] == ("(Replicate(), Shard(dim=0))",) * 2
    assert pl["final_norm/scale"] == ("(Replicate(), Replicate())",) * 2
    ada = res["qwen3-adafactor"]
    i = list(ada["placements"]).index("periods/pos0/mixer/wo")  # P(None, model, None, data)
    assert ada["nu"][i] == {"row": "(Replicate(), Shard(dim=1))",
                            "col": "(Shard(dim=2), Shard(dim=1))"}
    assert res["dtensor_params"]


def test_named_placements_round_trip_through_distribute_tensor(group):
    res, _ = group
    assert res["round_trip"] == {k: True for k in res["round_trip"]} and res["round_trip"]


def test_constrain_follows_a_policy_that_folds_model_into_the_batch(group):
    res, _ = group
    placements, local_ok, placements2, full_ok = res["constrain"]
    want = res["expected_placements"]
    assert placements == want and placements2 == want and local_ok and full_ok
    assert "mesh's axis order" in res["against_order"]


def test_the_ssd_wrappers_refuse_a_dtensor(group):
    res, _ = group
    assert "not DTensors" in res["ssd_dtensor"]


def test_production_meshes_refuse_another_world_size(group):
    res, _ = group
    assert res["production"] == ["a (16, 16) ('data', 'model') mesh needs 256 ranks, the "
                                 "process group has 8",
                                 "a (2, 16, 16) ('pod', 'data', 'model') mesh needs 512 ranks, "
                                 "the process group has 8"]
