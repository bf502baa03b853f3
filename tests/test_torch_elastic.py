"""Elastic fault tolerance under a mesh: the port of ``tests/test_elastic.py``'s
resharding case, the meshed ``Trainer``'s preemption and restart, and the
launcher under ``torchrun``, on gloo ranks (the group harness of
``test_torch_distributed.py``; the tests skip with the reason where ranks
cannot be spawned).

* On 8 ranks: qwen3 SMOKE's parameters and AdamW moments sharded on a 4 x 2
  mesh are saved (gathered whole, written by one rank) and restored onto a
  2 x 4 mesh with ``shardings=``: every leaf bit-equal, each restored
  DTensor on the 2 x 4 mesh; without ``shardings`` a DTensor target's own
  placements are kept.
* On 4 ranks (2 x 2): ``Trainer(mesh=)`` runs a step, is preempted after the
  next (the sentinel file, seen by every rank), restarts from its
  checkpoint and runs 2 more; its losses and final parameters and moments
  equal an uninterrupted 4-step run's bit for bit.
* ``python -m torch.distributed.run --nproc-per-node 2 -m
  repro_torch.launch.train --device cpu`` trains and resumes, rank 0 alone
  printing.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from test_torch_distributed import run_group

from repro_torch.configs import get_smoke_config

REPO = Path(__file__).resolve().parents[1]


def _cfg():
    return dataclasses.replace(get_smoke_config("qwen3-0.6b"), n_layers=2)


def _reshard(rank: int, world: int, directory: str) -> dict | None:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed.sharding import full_tensor, named, use_mesh
    from repro_torch.models.lm import init_lm, param_leaves, shard_lm
    from repro_torch.optim import make_optimizer

    names = ("data", "model")
    mesh_a = init_device_mesh("cpu", (4, 2), mesh_dim_names=names)
    mesh_b = init_device_mesh("cpu", (2, 4), mesh_dim_names=names)
    cfg = _cfg()
    model = init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                    dtype=cfg.param_dtype)
    whole = [leaf.value().clone() for leaf in param_leaves(model)]
    shard_lm(model, mesh_a)
    leaves = param_leaves(model)
    opt = make_optimizer(cfg.optimizer)[0](leaves)
    for i, m in enumerate(opt.mu):  # moments that differ from their zeros
        m.add_(float(i))
    tree = [leaf.value() for leaf in leaves] + opt.tensors()
    saved = [full_tensor(t).clone() for t in tree]
    manager = CheckpointManager(directory)
    manager.save(7, tree, blocking=True)
    shardings = [named(leaf.spec, leaf.shape, mesh_b) for leaf in leaves]
    shardings += [None] + [named(leaf.spec, leaf.shape, mesh_b) for leaf in leaves] * 2
    with use_mesh(mesh_b):
        restored = manager.restore(7, whole + [t if i == 0 else full_tensor(t)
                                               for i, t in enumerate(opt.tensors())],
                                   shardings=shardings)
    kept = manager.restore(7, tree)  # DTensor targets, no shardings: their own placements
    res = {  # every rank gathers: full_tensor is a collective
        "bit_equal": [bool(torch.equal(full_tensor(r), s)) for r, s in zip(restored, saved)],
        "params_are_the_draw": all(torch.equal(a, b) for a, b in zip(saved, whole)),
        "on_b": [r.device_mesh is mesh_b for r in restored if hasattr(r, "device_mesh")],
        "mesh_b": dict(zip(mesh_b.mesh_dim_names, mesh_b.shape)),
        "kept": [getattr(k, "placements", None) == getattr(t, "placements", None)
                 and torch.equal(full_tensor(k), s) for k, t, s in zip(kept, tree, saved)],
        "files": sorted(os.listdir(directory)),
    }
    return None if rank else res


def test_checkpoint_saved_on_4x2_restores_onto_2x4_bit_for_bit(tmp_path):
    res = run_group(8, _reshard, str(tmp_path))[0]
    assert res["params_are_the_draw"]
    assert res["bit_equal"] and all(res["bit_equal"])
    assert res["on_b"] and all(res["on_b"]) and res["mesh_b"] == {"data": 2, "model": 4}
    assert all(res["kept"])
    assert res["files"] == ["step_0000000007"]


def _restart(rank: int, world: int, directory: str) -> dict | None:
    import torch.distributed as dist

    from repro_torch.distributed.sharding import full_tensor
    from repro_torch.launch.mesh import mesh_for_devices
    from repro_torch.train.loop import Trainer
    from repro_torch.train.steps import TrainHParams

    mesh = mesh_for_devices(model=2, device="cpu")
    hp = TrainHParams(remat=False, warmup=2, total_steps=50)
    kw = dict(batch=4, seq=16, hp=hp, mesh=mesh, ckpt_every=1000, seed=3, device="cpu")
    run = Path(directory) / "run"
    first = Trainer(_cfg(), ckpt_dir=run, **kw)
    first.run(1, log_every=1)
    if rank == 0:
        (run / "PREEMPT").write_text("")
    dist.barrier()
    first.run(10, log_every=1)  # preempted after its next step
    first.data.close()
    dist.barrier()
    if rank == 0:
        (run / "PREEMPT").unlink()
    dist.barrier()
    again = Trainer(_cfg(), ckpt_dir=run, **kw)
    resumed_at = again.step
    again.run(2, log_every=1)
    again.data.close()
    straight = Trainer(_cfg(), ckpt_dir=Path(directory) / "straight", **kw)
    straight.run(4, log_every=1)
    straight.data.close()
    res = {  # every rank gathers: full_tensor is a collective
        "preempted_at": first.step, "resumed_at": resumed_at,
        "losses": [m["loss"] for m in first.metrics_log + again.metrics_log],
        "straight": [m["loss"] for m in straight.metrics_log],
        "same_state": all(torch.equal(full_tensor(a), full_tensor(b))
                          for a, b in zip(again.state(), straight.state())),
        "sharded": type(again.state()[0]).__name__,
    }
    return None if rank else res


def test_meshed_trainer_restarts_after_preemption_bit_for_bit(tmp_path):
    res = run_group(4, _restart, str(tmp_path))[0]
    assert res["preempted_at"] == 2 and res["resumed_at"] == 2
    assert len(res["straight"]) == 4 and all(np.isfinite(res["straight"]))
    assert res["losses"] == res["straight"]
    assert res["same_state"] and res["sharded"] == "DTensor"


def test_torchrun_drives_the_launcher_on_gloo_ranks(tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "repro_torch.launch.train", "--arch", "qwen3-0.6b", "--smoke",
           "--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "16", "--ckpt-dir",
           str(tmp_path), "--ckpt-every", "2", "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    outs = []
    for _ in range(2):
        try:
            res = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
        except OSError as e:
            pytest.skip(f"cannot start torchrun here: {e!r}")
        assert res.returncode == 0, res.stderr[-3000:]
        outs.append(res.stdout)
    assert outs[0].count("ran 2 steps (resumed from 0)") == 1, outs[0]
    assert outs[1].count("ran 2 steps (resumed from 2)") == 1, outs[1]
    steps = [line.split("step=")[1].split()[0] for out in outs for line in out.splitlines()
             if "step=" in line]
    assert steps == ["1", "2", "3", "4"]
