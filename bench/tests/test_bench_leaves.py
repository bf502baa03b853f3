"""The benchmark's weights: the committed configurations' leaves and draws
pinned as they were before a configuration could declare its own, and a
card's share of an expert-parallel layer (``conftest.py``) declared by its
toy reference, drawn, checked against the program's leaves and refused by
the plain ``lm`` reference."""
from __future__ import annotations

import math

import pytest
import torch

from bench import inputs, registry
from bench.drivers import train

SEED = 2 ** 31 + 4242
LM = registry.reference("lm")

#: (key, shape, init, scale) of every leaf, in the order they are drawn
SNAPSHOT = {
    "mamba2-370m": [
        ("embed/head", (1024, 50304), "normal", 0.03125),
        ("embed/table", (50304, 1024), "normal", 1.0),
        ("final_norm/scale", (1024,), "ones", 0.0),
        ("periods/pos0/mixer/A_log", (48, 32), "a_log", 0.0),
        ("periods/pos0/mixer/D", (48, 32), "ones", 0.0),
        ("periods/pos0/mixer/conv_B", (48, 4, 128), "normal", 0.5),
        ("periods/pos0/mixer/conv_C", (48, 4, 128), "normal", 0.5),
        ("periods/pos0/mixer/conv_x", (48, 4, 2048), "normal", 0.5),
        ("periods/pos0/mixer/dt_bias", (48, 32), "dt_bias", 0.0),
        ("periods/pos0/mixer/norm/scale", (48, 2048), "ones", 0.0),
        ("periods/pos0/mixer/w_B", (48, 1024, 128), "normal", 0.03125),
        ("periods/pos0/mixer/w_C", (48, 1024, 128), "normal", 0.03125),
        ("periods/pos0/mixer/w_dt", (48, 1024, 32), "normal", 0.03125),
        ("periods/pos0/mixer/w_out", (48, 2048, 1024), "normal", 0.02209708691207961),
        ("periods/pos0/mixer/w_x", (48, 1024, 2048), "normal", 0.03125),
        ("periods/pos0/mixer/w_z", (48, 1024, 2048), "normal", 0.03125),
        ("periods/pos0/norm1/scale", (48, 1024), "ones", 0.0),
    ],
    "olmoe-1b-7b-l4": [
        ("embed/head", (2048, 50304), "normal", 0.02209708691207961),
        ("embed/table", (50304, 2048), "normal", 1.0),
        ("final_norm/scale", (2048,), "ones", 0.0),
        ("periods/pos0/ffn/router", (4, 2048, 64), "normal", 0.02209708691207961),
        ("periods/pos0/ffn/w1", (4, 64, 2048, 1024), "normal", 0.02209708691207961),
        ("periods/pos0/ffn/w2", (4, 64, 1024, 2048), "normal", 0.03125),
        ("periods/pos0/ffn/w3", (4, 64, 2048, 1024), "normal", 0.02209708691207961),
        ("periods/pos0/mixer/k_norm/scale", (4, 128), "ones", 0.0),
        ("periods/pos0/mixer/q_norm/scale", (4, 128), "ones", 0.0),
        ("periods/pos0/mixer/wk", (4, 2048, 16, 128), "normal", 0.02209708691207961),
        ("periods/pos0/mixer/wo", (4, 16, 128, 2048), "normal", 0.02209708691207961),
        ("periods/pos0/mixer/wq", (4, 2048, 16, 128), "normal", 0.02209708691207961),
        ("periods/pos0/mixer/wv", (4, 2048, 16, 128), "normal", 0.02209708691207961),
        ("periods/pos0/norm1/scale", (4, 2048), "ones", 0.0),
        ("periods/pos0/norm2/scale", (4, 2048), "ones", 0.0),
    ],
}


def _drawn_before(arch: dict, seed: int, device):
    """The draw as it stood before a reference could declare its leaves:
    the generator calls over the default list, kept here as they were."""
    g = torch.Generator(device).manual_seed(int(seed))
    for key, shape, init, scale in inputs.leaf_specs(arch):
        if init == "normal":
            t = torch.randn(shape, generator=g, device=device).mul_(scale)
        elif init == "ones":
            t = torch.ones(shape, device=device)
        elif init == "a_log":
            t = torch.rand(shape, generator=g, device=device).mul_(15).add_(1).log_()
        elif init == "dt_bias":
            u = torch.rand(shape, generator=g, device=device)
            dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
            t = dt + torch.log(-torch.expm1(-dt))
        else:
            raise ValueError(init)
        yield key, t


@pytest.mark.parametrize("name", sorted(SNAPSHOT))
def test_a_committed_configuration_keeps_its_leaves(name):
    config = registry.config(name)
    assert inputs.config_specs(config) == SNAPSHOT[name]
    assert inputs.leaf_specs(config["arch"]) == SNAPSHOT[name]


@pytest.mark.parametrize("name", sorted(SNAPSHOT))
def test_a_committed_configuration_draws_the_same_weights(name):
    """At a CPU size (the widths shrunk, every leaf kind kept), the weights
    through :func:`bench.inputs.config_specs` are bit for bit those drawn
    before, in the same order."""
    config = registry.config(name)
    a = config["arch"]
    a.update(n_layers=len(a["period"]) * 2, d_model=64, vocab=512, ssm_state=16,
             ssm_head_dim=16, n_heads=4, n_kv_heads=4, head_dim=16, moe_experts=8, moe_d_ff=32)
    got = list(inputs.iter_weights(inputs.config_specs(config), SEED, "cpu"))
    want = list(_drawn_before(a, SEED, "cpu"))
    assert [k for k, _ in got] == [k for k, _ in want]
    assert all(torch.equal(g, w) for (_, g), (_, w) in zip(got, want))


def test_a_reference_declares_its_configuration_s_leaves(share_config):
    """The toy reference's list is the configuration's: a tied head (no
    ``embed/head``), a conv bias drawn as zeros, a router over all 16
    experts and the 4 held experts' weights, a shared expert; drawn the same
    from the same seed, otherwise from another."""
    specs = inputs.config_specs(share_config)
    shapes = {key: shape for key, shape, _, _ in specs}
    assert "embed/head" not in shapes and "embed/table" in shapes
    assert shapes["periods/pos0/ffn/router"] == (1, 64, 16)
    assert shapes["periods/pos1/ffn/w1"] == (1, 4, 64, 32)
    assert shapes["periods/pos0/ffn/shared/w1"] == (1, 64, 48)
    assert shapes["periods/pos0/mixer/conv_bias"] == (1, 128 + 2 * 16)
    w = inputs.weights(specs, SEED, "cpu")
    assert list(w) == [key for key, _, _, _ in specs]
    assert all(tuple(w[key].shape) == shape for key, shape in shapes.items())
    assert not w["periods/pos0/mixer/conv_bias"].any()
    again, other = inputs.weights(specs, SEED, "cpu"), inputs.weights(specs, SEED + 1, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    assert not torch.equal(w["periods/pos0/ffn/router"], other["periods/pos0/ffn/router"])


def test_the_leaf_check_names_what_differs(share_config):
    specs = inputs.config_specs(share_config)
    have = {key: torch.Size(shape) for key, shape, _, _ in specs}
    train.check_leaves(have, specs)
    del have["periods/pos0/mixer/conv_bias"]
    have["periods/pos0/ffn/router"] = torch.Size((1, 64, 4))
    have["embed/head"] = torch.Size((64, 512))
    with pytest.raises(RuntimeError) as e:
        train.check_leaves(have, specs)
    assert ("only the program's [('embed/head', (64, 512)), "
            "('periods/pos0/ffn/router', (1, 64, 4))]") in str(e.value)
    assert ("only the benchmark's [('periods/pos0/ffn/router', (1, 64, 16)), "
            "('periods/pos0/mixer/conv_bias', (1, 160))]") in str(e.value)


@pytest.mark.parametrize("key", inputs.SHARE_KEYS)
def test_the_lm_reference_refuses_a_share(toy_arch, key):
    """A configuration that names ``lm`` with an expert share or a shared
    expert fails at set-up (its leaf list) and in the reference itself."""
    arch = dict(toy_arch, **{k: 4 if k == key else 0 for k in inputs.SHARE_KEYS})
    with pytest.raises(ValueError, match=key):
        inputs.config_specs({"reference": "lm", "arch": arch})
    with pytest.raises(ValueError, match=key):
        LM.train_steps(arch, {}, {}, {}, [])
