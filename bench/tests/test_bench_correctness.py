"""The correctness check of a training cell, at a size a CPU test run holds:
the plain reference against the port, the control and the faults against
the cell's limits.

The configurations are cut to 2 layers at small widths (the port's SMOKE
sizes), 4 rows of 32 tokens, and computed in float32, where the port and the
reference agree to rounding; the cell's own limits (set at its timed size
in bfloat16) then hold the sound run, and each fault and the control must
exceed one of them.  The control at the cell's own size runs on the card.
"""
from __future__ import annotations

import copy
import time

import pytest
import torch

from bench import registry
from bench.drivers import train
from bench.run import Run

CELLS = [c["name"] for c in registry.benchmark()["workloads"]]
SEED = 2 ** 31 + 12345


def _small(cell: str, compute: str = "float32"):
    """The cell's configuration and mix at a CPU test's size."""
    w = registry.workload(cell)
    config, mix = copy.deepcopy(registry.config(w["config"])), dict(registry.traffic(w["traffic"]))
    a = config["arch"]
    if a["period"] == ["mamba"]:
        a.update(n_layers=2, d_model=64, vocab=512, ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    else:
        a.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32, vocab=512,
                 head_dim=16, moe_experts=8, moe_top_k=2, moe_d_ff=32, moe_group_size=32)
    a["compute_dtype"] = compute
    config["batch"], mix["seq"] = 4, 32
    return config, mix


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_follows_the_port_s_steps(cell, tmp_path):
    """Loss per step, first clipped gradient per part and the parameters'
    change after the checked steps (AdamW): the port and the reference."""
    config, mix = _small(cell)
    trainer = train.make_trainer(config, mix, SEED, "cpu", tmp_path)
    prog, _ = train.program_readings(trainer, config, mix, SEED)
    trainer.data.close()
    ref = train.reference_readings(config, mix, SEED, "cpu")
    found = train.gaps(prog, ref)
    assert len(prog["loss"]) == mix["check_steps"]
    assert found["loss_gap"] < 1e-6
    assert found["first_grad_gap"] < 1e-5
    assert found["update_gap"] < 1e-4
    assert found["parts_left_out"] == 0


def _run(cell, monkeypatch=None, fault=None, trace=False) -> dict:
    config, mix = _small(cell)
    if fault is not None:
        import repro_torch.train.loop as loop
        from repro_torch.train.steps import loss_fn

        real = loop.make_train_step

        def broken(cfg, hp):
            step = real(cfg, hp)
            if fault == "unchanged":
                def unchanged(model, opt_state, batch):  # the loss, and no update
                    with torch.no_grad():
                        loss, metrics = loss_fn(model, batch, cfg, hp)
                    return model, opt_state, dict(metrics, loss=loss,
                                                  grad_norm=torch.tensor(0.0))
                return unchanged

            def half(model, opt_state, batch):  # half of the batch, the mean over the rest
                return step(model, opt_state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
            return half

        monkeypatch.setattr(loop, "make_train_step", broken)
    run = Run(workload=cell, config=config, mix=mix, seed=SEED, seconds=0.5, trace=trace,
              device="cpu", t_start=time.perf_counter())
    return train.run(run)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0


def test_a_traced_run_times_a_chunk_without_the_profiler():
    """``--trace 1``: chunks timed alone, whose pace the step's MFU reads,
    then the profiled steps; all count as attempted."""
    cell = CELLS[0]
    out = _run(cell, trace=True)
    mix = registry.traffic(registry.workload(cell)["traffic"])
    t = out["trace"]
    assert out["correct"], out["checks"]
    plain = mix["chunk_steps"] * mix["plain_chunks"]
    assert out["attempted"] == plain + mix["trace_steps"] and out["failed"] == 0
    assert (t.plain_steps, t.steps) == (plain, mix["trace_steps"])
    assert 0 < t.plain_s and 0 < t.window_s
    mfu = registry.metric_reader("train_step_mfu_pct")(t)
    assert 0 < mfu < 100


def test_the_layer_gap_catches_a_fault_in_a_leaf_and_not_a_spike():
    """A gradient 10 % off in every layer reads its 10 %; 5x off in one
    layer of four moves no median."""
    assert train._layer_gap([0.9, 1.8, 0.45, 0.9], [1.0, 2.0, 0.5, 1.0]) == pytest.approx(0.1)
    assert train._layer_gap([5.0, 2.0, 0.5, 1.0], [1.0, 2.0, 0.5, 1.0]) == 0.0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch):
    """A step that returns its state unchanged, and one that leaves half of
    the batch out, under the whole run: ``correct`` comes out false."""
    out = _run(cell, monkeypatch, fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_cell_s_limits(cell):
    """The reference in the program's place, computing in float8 (the
    precision below the configuration's bfloat16), against the float32
    reference: beyond one of the cell's limits."""
    config, mix = _small(cell)
    ref = train.reference_readings(config, mix, SEED, "cpu")
    ctl = train.reference_readings(config, mix, SEED, "cpu", precision="float8")
    found = train.gaps(ctl, ref)
    assert any(found[k] > config["limits"][k] for k in config["limits"]), found


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cell_s_size_on_the_card(cell):
    """The control at the cell's own size and batch (the card's memory)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's timed size")
    w = registry.workload(cell)
    config, mix = registry.config(w["config"]), registry.traffic(w["traffic"])
    ref = train.reference_readings(config, mix, SEED, "cuda")
    ctl = train.reference_readings(config, mix, SEED, "cuda", precision="float8")
    found = train.gaps(ctl, ref)
    assert any(found[k] > config["limits"][k] for k in config["limits"]), found


@pytest.mark.parametrize("cell", CELLS)
def test_the_rounding_ladder(cell):
    """The reference computing in bfloat16 (the configurations' compute
    type, the witness of the look at mamba2's gradients) lies nearer the
    float32 reference than the float8 control on the loss and on the
    first gradient's parts."""
    config, mix = _small(cell)
    ref = train.reference_readings(config, mix, SEED, "cpu")
    bf16, fp8 = (train.gaps(train.reference_readings(config, mix, SEED, "cpu", precision=p), ref)
                 for p in ("bfloat16", "float8"))
    for number in ("loss_gap", "raw_grad_median_gap"):
        assert 0 < bf16[number] < fp8[number], (number, bf16, fp8)
