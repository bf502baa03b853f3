"""The granite-4.0-h-small configuration (``granite-4.0-h-small-p10``: one
10-layer period, 9 of 72 experts held) and its reference
(``bench/reference/granite.py``): its frozen N against the port's
parameter count, its leaves against the port's trainer, and its cell's
correctness check at a size a CPU test run holds (the widths of the port's
SMOKE configuration, one whole period, 4 of 8 experts held), as
``test_bench_correctness.py`` holds the other cells: a sound run is
correct, a broken step and the float8 control are not."""
from __future__ import annotations

import copy
import dataclasses
import time

import pytest
import torch

from bench import inputs, registry
from bench.counts import flops
from bench.drivers import train
from bench.run import Run

CELL = "granite-4.0-h-small-p10.train-4k"
CONFIG = "granite-4.0-h-small-p10"
SEED = 2 ** 31 + 30303


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: one thread runs them fastest, and parallel workers do
    not contend for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _small(compute: str = "float32"):
    """The cell's configuration and mix at the SMOKE widths, one period."""
    w = registry.workload(CELL)
    config, mix = copy.deepcopy(registry.config(w["config"])), dict(registry.traffic(w["traffic"]))
    config["arch"].update(d_model=64, n_heads=4, n_kv_heads=2, d_ff=32, vocab=512, head_dim=16,
                          moe_experts=8, moe_experts_held=4, moe_top_k=2, moe_d_ff=32,
                          moe_shared_d_ff=48, moe_group_size=32, ssm_state=16, ssm_head_dim=16,
                          ssm_chunk=8, attention_multiplier=1 / 16, compute_dtype=compute)
    config["batch"], mix["seq"] = 4, 32
    return config, mix


def test_the_frozen_n_is_the_port_s_active_parameters():
    """The tied table is stored once and counted once, as the head's
    product: N is the cut's whole active count, the embedding not taken
    off as it is for an untied head."""
    from repro_torch.configs import get_config

    arch = registry.config(CONFIG)["arch"]
    port = dataclasses.replace(get_config(arch["name"]), tp=1, n_layers=arch["n_layers"],
                               moe_experts_held=arch["moe_experts_held"])
    assert flops.matmul_params(arch) == 1_682_767_872 == port.active_param_count()
    assert port.param_count() == 2_414_149_632


def test_the_reference_s_leaves_are_the_port_s(tmp_path):
    config, mix = _small()
    specs = inputs.config_specs(config)
    shapes = {key: shape for key, shape, _, _ in specs}
    assert "embed/head" not in shapes
    assert shapes["periods/pos0/ffn/router"] == (1, 64, 8)
    assert shapes["periods/pos5/ffn/w1"] == (1, 4, 64, 32)
    assert shapes["periods/pos9/ffn/shared/w2"] == (1, 48, 64)
    assert shapes["periods/pos0/mixer/conv_x_bias"] == (1, 128)
    trainer = train.make_trainer(config, mix, SEED, "cpu", tmp_path)  # check_leaves inside
    try:
        train.check_leaves({"/".join(leaf.path): leaf.shape for leaf in trainer.leaves}, specs)
    finally:
        trainer.data.close()


def test_the_full_size_leaves_hold_the_cut():
    """At the file's own widths: the router's 72 outputs, 9 held experts of
    768, the shared expert of 1536, one table of 100352 x 4096."""
    shapes = {key: shape for key, shape, _, _ in inputs.config_specs(registry.config(CONFIG))}
    assert shapes["embed/table"] == (100352, 4096)
    assert shapes["periods/pos0/ffn/router"] == (1, 4096, 72)
    assert shapes["periods/pos5/ffn/w2"] == (1, 9, 768, 4096)
    assert shapes["periods/pos5/ffn/shared/w1"] == (1, 4096, 1536)
    assert shapes["periods/pos5/mixer/wk"] == (1, 4096, 8, 128)
    assert shapes["periods/pos4/mixer/w_x"] == (1, 4096, 8192)
    assert sum(1 for k in shapes if k.endswith("mixer/A_log")) == 9


def _run(monkeypatch=None, fault=None) -> dict:
    config, mix = _small()
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

            def half(model, opt_state, batch):  # half of the batch
                return step(model, opt_state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
            return half

        monkeypatch.setattr(loop, "make_train_step", broken)
    run = Run(workload=CELL, config=config, mix=mix, seed=SEED, seconds=0.5, trace=False,
              device="cpu", t_start=time.perf_counter())
    return train.run(run)


def test_a_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(fault, monkeypatch):
    out = _run(monkeypatch, fault)
    assert not out["correct"], out["checks"]


def test_the_control_fails_the_cell_s_limits():
    config, mix = _small()
    ref = train.reference_readings(config, mix, SEED, "cpu")
    ctl = train.reference_readings(config, mix, SEED, "cpu", precision="float8")
    found = train.gaps(ctl, ref)
    assert any(found[k] > config["limits"][k] for k in config["limits"]), found
