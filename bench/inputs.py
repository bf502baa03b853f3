"""The benchmark's inputs, made from ``--seed``: token batches and initial
weights.  Both sides of a comparison get exactly these: the program through
its feed and its parameters, the plain reference directly.  Nothing here
imports the program.

Weights are keyed as the parameter leaves of a language model: ``/``-joined
paths (``embed/table``, ``periods/pos0/mixer/w_x``, ...), the tensors of a
layer kind repeated over the periods stacked on a leading axis.  They are
drawn on the device with one ``torch.Generator`` in a fixed order, one
``randn`` call per leaf, in float32 (the master weights' type).

A configuration's leaves are its plain reference's to declare: where
``bench/reference/<config's reference>.py`` defines ``leaf_specs(arch)``,
that list is the configuration's (:func:`config_specs`); otherwise
:func:`leaf_specs` here, the plain ``lm`` reference's layout, which holds
every expert and no shared expert, conv bias or tied head.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from bench import registry

__all__ = ["padded_vocab", "leaf_specs", "config_specs", "iter_weights", "weights", "tokens"]

#: ``arch`` keys of an expert-parallel share that :func:`leaf_specs` and the
#: plain ``lm`` reference do not implement (0, their default, means none)
SHARE_KEYS = ("moe_experts_held", "moe_shared_d_ff")


def padded_vocab(arch: dict) -> int:
    """The vocabulary padded to a multiple of ``tp * 128`` (the program's
    logits and output head have this many columns; the loss masks the
    padding)."""
    m = arch["tp"] * 128
    return -(-arch["vocab"] // m) * m


def _ffn_kind(arch: dict, pos: int) -> str:
    if pos in arch["moe_positions"]:
        return "moe"
    if arch["period"][pos] == "mamba" and arch["family"] == "ssm":
        return "none"
    return "mlp"


def leaf_specs(arch: dict) -> list[tuple[str, tuple, str, float]]:
    """(key, shape, init, scale) of every leaf, sorted by key.  ``init`` is
    ``normal`` (``scale`` times N(0, 1)), ``ones``, ``a_log`` (log of
    U(1, 16)) or ``dt_bias`` (the inverse softplus of a step drawn
    log-uniformly in [1e-3, 1e-1]), as Mamba-2 initialises them."""
    share = [k for k in SHARE_KEYS if arch.get(k, 0)]
    if share:
        raise ValueError(f"{arch['name']}: the default leaf list holds every expert and no "
                         f"shared expert, so it cannot take {share}; such a configuration names "
                         f"a reference of its own that defines leaf_specs(arch)")
    if arch["tp"] != 1:
        raise ValueError("the benchmark runs its configurations at tp=1 (no padded heads)")
    d, vp = arch["d_model"], padded_vocab(arch)
    n_per = arch["n_layers"] // len(arch["period"])
    specs = [("embed/table", (vp, d), "normal", 1.0),
             ("embed/head", (d, vp), "normal", d ** -0.5),
             ("final_norm/scale", (d,), "ones", 0.0)]
    for i, kind in enumerate(arch["period"]):
        pre = f"periods/pos{i}"
        leaves = [("norm1/scale", (d,), "ones", 0.0)]
        if kind == "mamba":
            din = arch["ssm_expand"] * d
            n, k = arch["ssm_state"], arch["ssm_conv"]
            h = din // arch["ssm_head_dim"]
            leaves += [("mixer/w_x", (d, din), "normal", d ** -0.5),
                       ("mixer/w_z", (d, din), "normal", d ** -0.5),
                       ("mixer/w_B", (d, n), "normal", d ** -0.5),
                       ("mixer/w_C", (d, n), "normal", d ** -0.5),
                       ("mixer/w_dt", (d, h), "normal", d ** -0.5),
                       ("mixer/conv_x", (k, din), "normal", k ** -0.5),
                       ("mixer/conv_B", (k, n), "normal", k ** -0.5),
                       ("mixer/conv_C", (k, n), "normal", k ** -0.5),
                       ("mixer/w_out", (din, d), "normal", din ** -0.5),
                       ("mixer/dt_bias", (h,), "dt_bias", 0.0),
                       ("mixer/A_log", (h,), "a_log", 0.0),
                       ("mixer/D", (h,), "ones", 0.0),
                       ("mixer/norm/scale", (din,), "ones", 0.0)]
        elif kind == "attn":
            hq, hkv, dh = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
            leaves += [("mixer/wq", (d, hq, dh), "normal", d ** -0.5),
                       ("mixer/wk", (d, hkv, dh), "normal", d ** -0.5),
                       ("mixer/wv", (d, hkv, dh), "normal", d ** -0.5),
                       ("mixer/wo", (hq, dh, d), "normal", (hq * dh) ** -0.5)]
            if arch["qk_norm"]:
                leaves += [("mixer/q_norm/scale", (dh,), "ones", 0.0),
                           ("mixer/k_norm/scale", (dh,), "ones", 0.0)]
        else:
            raise ValueError(f"layer kind {kind!r} has no reference here")
        fk = _ffn_kind(arch, i)
        if fk != "none":
            leaves.append(("norm2/scale", (d,), "ones", 0.0))
        if fk == "moe":
            e, f = arch["moe_experts"], arch["moe_d_ff"] or arch["d_ff"]
            leaves += [("ffn/router", (d, e), "normal", d ** -0.5),
                       ("ffn/w1", (e, d, f), "normal", d ** -0.5),
                       ("ffn/w3", (e, d, f), "normal", d ** -0.5),
                       ("ffn/w2", (e, f, d), "normal", f ** -0.5)]
        elif fk == "mlp":
            f = arch["d_ff"]
            leaves += [("ffn/w1", (d, f), "normal", d ** -0.5),
                       ("ffn/w3", (d, f), "normal", d ** -0.5),
                       ("ffn/w2", (f, d), "normal", f ** -0.5)]
        specs += [(f"{pre}/{key}", (n_per, *shape), init, scale)
                  for key, shape, init, scale in leaves]
    return sorted(specs)


def config_specs(config: dict) -> list[tuple[str, tuple, str, float]]:
    """The leaves of a configuration (a ``bench/configs/<name>.json`` dict):
    its reference's ``leaf_specs(arch)`` where the reference defines one,
    else :func:`leaf_specs`."""
    own = getattr(registry.reference(config["reference"]), "leaf_specs", None)
    return (own or leaf_specs)(config["arch"])


def iter_weights(specs: list, seed: int, device):
    """Yield (key, float32 tensor) for every leaf of ``specs`` (from
    :func:`config_specs`), in its order; the same ``seed`` gives the same
    tensors on the same device.  ``zeros`` and ``ones`` draw nothing."""
    g = torch.Generator(device).manual_seed(int(seed))
    for key, shape, init, scale in specs:
        if init == "normal":
            t = torch.randn(shape, generator=g, device=device).mul_(scale)
        elif init == "ones":
            t = torch.ones(shape, device=device)
        elif init == "zeros":
            t = torch.zeros(shape, device=device)
        elif init == "a_log":
            t = torch.rand(shape, generator=g, device=device).mul_(15).add_(1).log_()
        elif init == "dt_bias":
            u = torch.rand(shape, generator=g, device=device)
            dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
            t = dt + torch.log(-torch.expm1(-dt))
        else:
            raise ValueError(init)
        yield key, t


def weights(specs: list, seed: int, device) -> dict[str, torch.Tensor]:
    """Every leaf of :func:`iter_weights`, as a dict."""
    return dict(iter_weights(specs, seed, device))


def tokens(seed: int, step: int, batch: int, seq: int, vocab: int) -> np.ndarray:
    """The token batch of training step ``step`` (counting from 0): ids
    uniform over the real vocabulary, int32 (batch, seq)."""
    rng = np.random.default_rng([int(seed), int(step), 0x5EED])
    return rng.integers(0, vocab, size=(batch, seq), dtype=np.int32)
