"""A configuration that the committed ones do not show: a card's share of an
expert-parallel hybrid layer (``moe_experts_held`` of ``moe_experts``), a
shared expert (``moe_shared_d_ff``), a conv bias and a tied output head,
with a toy reference of its own that declares those leaves.  Written under
``tmp_path``, never committed, and found by name as a committed one is."""
from __future__ import annotations

import json
import textwrap

import pytest

from bench import registry

#: the toy reference: every leaf of one period, its router over all 16
#: experts, the 4 held experts' weights, a shared expert, a conv bias over
#: x, B and C, and no ``embed/head`` (the head is the table, tied)
TOY_REFERENCE = textwrap.dedent('''
    """A toy reference that declares its own leaves (and computes nothing)."""


    def leaf_specs(arch):
        d, v = arch["d_model"], arch["vocab"]
        n_per = arch["n_layers"] // len(arch["period"])
        e, held = arch["moe_experts"], arch["moe_experts_held"]
        f, fs, n = arch["moe_d_ff"], arch["moe_shared_d_ff"], arch["ssm_state"]
        din = arch["ssm_expand"] * d
        hq, hkv, dh = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
        per = [("pos0/mixer/w_x", (d, din), "normal", d ** -0.5),
               ("pos0/mixer/conv_bias", (din + 2 * n,), "zeros", 0.0),
               ("pos0/mixer/A_log", (din // arch["ssm_head_dim"],), "a_log", 0.0),
               ("pos1/mixer/wq", (d, hq, dh), "normal", d ** -0.5),
               ("pos1/mixer/wk", (d, hkv, dh), "normal", d ** -0.5)]
        for pos in ("pos0", "pos1"):
            per += [(f"{pos}/ffn/router", (d, e), "normal", d ** -0.5),
                    (f"{pos}/ffn/w1", (held, d, f), "normal", d ** -0.5),
                    (f"{pos}/ffn/w2", (held, f, d), "normal", f ** -0.5),
                    (f"{pos}/ffn/shared/w1", (d, fs), "normal", d ** -0.5),
                    (f"{pos}/ffn/shared/w2", (fs, d), "normal", fs ** -0.5),
                    (f"{pos}/norm2/scale", (d,), "ones", 0.0)]
        return sorted([("embed/table", (v, d), "normal", 1.0),
                       ("final_norm/scale", (d,), "ones", 0.0)]
                      + [(f"periods/{k}", (n_per, *s), i, c) for k, s, i, c in per])
''')


@pytest.fixture
def toy_arch() -> dict:
    """The toy configuration's ``arch`` as a file written once the port has
    the share's two fields holds it (every field as it stood then): 2
    layers of a published 4, 4 of 16 experts held, a shared expert."""
    return {"name": "toy-share", "family": "hybrid", "n_layers": 2, "d_model": 64,
            "n_heads": 4, "n_kv_heads": 2, "d_ff": 32, "vocab": 512, "head_dim": 16,
            "qk_norm": False, "rope_theta": 10000.0, "period": ["mamba", "attn"],
            "moe_positions": [0, 1], "moe_experts": 16, "moe_top_k": 2, "moe_d_ff": 32,
            "moe_capacity_factor": 1.25, "moe_group_size": 256, "ssm_state": 16,
            "ssm_head_dim": 16, "ssm_expand": 2, "ssm_conv": 4, "ssm_chunk": 128,
            "enc_layers": 0, "n_context_tokens": 0, "kv_block": 256,
            "kv_cache_dtype": "bfloat16", "param_dtype": "float32", "compute_dtype": "bfloat16",
            "optimizer": "adamw", "tp": 1, "parallelism": "tp",
            "moe_experts_held": 4, "moe_shared_d_ff": 48}


@pytest.fixture
def share_config(toy_arch, tmp_path, monkeypatch) -> dict:
    """The toy configuration and its reference written under ``tmp_path``,
    which the registry then reads as the benchmark's directory; returns the
    configuration as :func:`bench.registry.config` reads it."""
    (tmp_path / "configs").mkdir()
    (tmp_path / "reference").mkdir()
    config = {"name": "toy-share", "reference": "toy", "reference_rows": 1, "batch": 2,
              "reduced": {"n_layers": "4 -> 2, one stage of a 2-stage pipeline",
                          "moe_experts_held": "4 of 16, rank 0 of a 4-way expert-parallel layer",
                          "batch": "one card's share"},
              "arch": toy_arch}
    (tmp_path / "configs" / "toy-share.json").write_text(json.dumps(config))
    (tmp_path / "reference" / "toy.py").write_text(TOY_REFERENCE)
    monkeypatch.setattr(registry, "BENCH", tmp_path)
    return registry.config("toy-share")
