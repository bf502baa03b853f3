"""Language models in PyTorch (dense / MoE / SSM / hybrid / VLM, and the
encoder-decoder) — the port of ``repro/models/lm.py``: ``init_lm``,
``init_caches``, ``encode``, ``lm_forward`` (the training forward:
differentiable, with the reference's remat per period and per position),
``lm_prefill`` and ``lm_decode`` (no gradient).

A serving model keeps its matrices in the compute dtype and its parameters
frozen (``init_lm``'s default); a training model (``dtype=cfg.param_dtype``,
float32 master weights, as the reference's ``init_lm``) has every
parameter require its gradient, and each use casts the weight to the
compute dtype.

The reference stacks the parameters of its repeated period and scans over
them; here each layer is its own ``Block`` in ``LM.layers`` (layer
``p * len(period) + i`` is period ``p``'s position ``i``) and owns its own
cache tensors: ``caches`` is a list with one slot dict per layer, holding
``"kv"`` (a ``KVCache``), ``"ssm"`` (a ``MambaCache``) and, in ``cross`` and
``dec`` layers, the context's K/V ``"cross_k"``/``"cross_v"``.
``lm_prefill`` and ``lm_decode`` write the caches in place.  An
encoder-decoder model also holds its ``Encoder`` (``enc_layers``
bidirectional attention + MLP blocks and a final norm), which
``lm_forward`` and ``lm_prefill`` run over the context (``cross_src``, the
stub frontend's frame embeddings); a VLM attends to ``cross_src`` as given.

Every entry point runs on the CUDA device unless the caller asks for the
CPU (``device="cpu"``), where the kernels run their plain versions.

``spec_lm``/``spec_encoder`` give the reference's logical partition specs,
as its pytree (the stacked leaves' specs with their replicated leading
axis).  :func:`shard_lm` stores a model's parameters as DTensors on a
``torch.distributed`` mesh, each placed by the sanitized spec of its
reference leaf (FSDP over ``data``, TP over ``model``): the persistent
state per rank is the reference's.  Each parameter is read through a
parametrization that gathers it to the full tensor where a layer reads it
(again in a remat recompute, as FSDP does), and whose backward turns the
full-size gradient of this rank's rows into the parameter's placements: a
reduce-scatter over the mesh dimensions that split the batch, this rank's
slice over the others.  Every rank of a model group therefore computes its
rows' layers whole — the reference's numbers, without its tensor-parallel
split of the activations — and the layers' code and kernels only ever see
plain tensors.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed.sharding import P, named
from repro_torch.runtime import resolve_device

from .blocks import apply_position, cache_position, ffn_kind, init_position, spec_position
from .config import ArchConfig
from .layers import (Embedding, _param, attention, embed, mlp, rms_norm, spec_embedding,
                     spec_norm, torch_dtype, unembed)

__all__ = ["LM", "Encoder", "ParamLeaf", "param_leaves", "init_lm", "spec_lm", "spec_encoder",
           "Gather", "shard_lm", "init_caches", "encode", "lm_forward", "lm_prefill",
           "lm_decode"]


class Encoder(nn.Module):
    """``enc_layers`` attention + MLP blocks and a final norm."""

    def __init__(self, cfg: ArchConfig, *, device="cuda", generator=None, dtype=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.layers = nn.ModuleList(
            init_position("attn", "mlp", cfg, device=device, generator=generator, dtype=dtype)
            for _ in range(cfg.enc_layers))
        self.final_norm = _param(torch.ones(cfg.d_model, device=device))


class LM(nn.Module):
    """Embedding, ``n_layers`` blocks, final norm; the encoder when the
    configuration has one.  ``dtype`` None: a serving model (matrices in
    the compute dtype, parameters frozen); a dtype: a training model
    (matrices in it, every parameter requires its gradient)."""

    def __init__(self, cfg: ArchConfig, *, device="cuda", generator=None, dtype=None):
        super().__init__()
        device = resolve_device(device)
        dtype = None if dtype is None else torch_dtype(dtype)
        self.cfg = cfg
        kw = dict(device=device, generator=generator, dtype=dtype)
        self.embed = Embedding(cfg, **kw)
        self.layers = nn.ModuleList(
            init_position(kind, ffn_kind(cfg, i), cfg, **kw)
            for _ in range(cfg.n_periods) for i, kind in enumerate(cfg.period))
        self.final_norm = _param(torch.ones(cfg.d_model, device=device))
        if cfg.is_encdec:
            self.encoder = Encoder(cfg, **kw)
        if dtype is not None:
            self.requires_grad_(True)
        self.sharding = None  # a Gather once shard_lm has placed the parameters
        self.param_specs = None  # the leaves' spec tree when it is not spec_lm's (shard_lm)

    @property
    def device(self) -> torch.device:
        """The device of this rank's parameters (read without a gather)."""
        return next(self.parameters()).device


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def _stack_specs(spec_tree):
    """Prepend the period-stack dim (replicated) to every leaf spec."""
    if isinstance(spec_tree, P):
        return P(None, *spec_tree)
    return {k: _stack_specs(v) for k, v in spec_tree.items()}


def spec_lm(cfg: ArchConfig) -> dict:
    """The reference's logical specs of ``init_lm``'s pytree."""
    period_spec = {
        f"pos{i}": spec_position(kind, ffn_kind(cfg, i), cfg)
        for i, kind in enumerate(cfg.period)
    }
    s = {
        "embed": spec_embedding(cfg),
        "periods": _stack_specs(period_spec),
        "final_norm": spec_norm(),
    }
    if cfg.is_encdec:
        s["encoder"] = spec_encoder(cfg)
    return s


def spec_encoder(cfg: ArchConfig) -> dict:
    return {
        "layers": _stack_specs(spec_position("attn", "mlp", cfg)),
        "final_norm": spec_norm(),
    }


@dataclasses.dataclass(frozen=True)
class ParamLeaf:
    """One leaf of the reference's ``init_lm`` pytree and the port's
    parameters that hold it: ``path`` is its key path (e.g. ``("periods",
    "pos0", "mixer", "w_x")``); a ``stacked`` leaf is the reference's
    stack of ``parts`` on a leading axis (one part per period, or per
    encoder layer), an unstacked one has one part."""

    path: tuple
    parts: tuple
    stacked: bool
    spec: P = P()  # the reference's logical spec of the leaf (spec_lm)

    @property
    def shape(self) -> tuple:
        s = tuple(self.parts[0].shape)
        return (len(self.parts), *s) if self.stacked else s

    def value(self) -> torch.Tensor:
        """The leaf as the reference holds it (a stacked copy, or the
        parameter itself)."""
        return torch.stack([p.detach() for p in self.parts]) if self.stacked else \
            self.parts[0].detach()

    @torch.no_grad()
    def take_grad(self) -> torch.Tensor:
        """The parts' gradients as one leaf (zeros where a part has none),
        leaving the parts without one.  On a sharded model the gradient is a
        DTensor with the leaf's placements."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.parts]
        for p in self.parts:
            p.grad = None
        return torch.stack(grads) if self.stacked else grads[0]

    def views(self, t: torch.Tensor) -> list[torch.Tensor]:
        """A leaf-shaped tensor as one view per part."""
        return list(t.unbind(0)) if self.stacked else [t]

    @torch.no_grad()
    def assign(self, value: torch.Tensor) -> None:
        """Write a leaf-shaped value back into the parts, in place."""
        for i, p in enumerate(self.parts):
            p.copy_(value[i] if self.stacked else value)


#: the port's parameters that are the reference's norms, ``{"scale": s}``
_NORMS = ("norm", "norm1", "norm2", "norm_x", "final_norm", "q_norm", "k_norm")


def param_leaves(model: "LM") -> list[ParamLeaf]:
    """The model's parameters grouped as the reference's pytree leaves, in
    its flatten order (``jax.tree.leaves``: dict keys sorted at every
    level): layer ``p * len(period) + i`` is part ``p`` of period position
    ``i``'s leaves, encoder layer ``j`` part ``j`` of the encoder's, and a
    norm's leaf ends in ``"scale"``.  The optimizer and the checkpoint walk
    this list, so that moments and checkpoints have the reference's leaves."""
    n = len(model.cfg.period)
    groups: dict[tuple, dict[int, nn.Parameter]] = {}
    single: dict[tuple, nn.Parameter] = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if "parametrizations" in parts:  # a sharded model: ...parametrizations.<name>.original
            i = parts.index("parametrizations")
            parts = parts[:i] + [parts[i + 1]]
        if parts[-1] in _NORMS:
            parts.append("scale")
        if parts[0] == "layers":
            i = int(parts[1])
            groups.setdefault(("periods", f"pos{i % n}", *parts[2:]), {})[i // n] = p
        elif parts[:2] == ["encoder", "layers"]:
            groups.setdefault(("encoder", "layers", *parts[3:]), {})[int(parts[2])] = p
        else:
            single[tuple(parts)] = p
    specs = model.param_specs or spec_lm(model.cfg)

    def spec(path: tuple) -> P:
        tree = specs
        for key in path:
            tree = tree[key]
        return tree

    leaves = [ParamLeaf(path, (p,), False, spec(path)) for path, p in single.items()]
    leaves += [ParamLeaf(path, tuple(per[j] for j in range(len(per))), True, spec(path))
               for path, per in groups.items()]
    return sorted(leaves, key=lambda leaf: leaf.path)


class Gather(nn.Module):
    """The parametrization of a sharded parameter: its DTensor read as the
    full tensor (an all-gather over the mesh dimensions that shard it).

    In the backward the full-size gradient of this rank's rows is taken as a
    pending sum over ``batch_dims`` (the mesh dimensions that split the
    batch) and as the same on every rank of the others, and DTensor brings
    it to the parameter's placements: a reduce-scatter (or an all-reduce,
    for a parameter replicated there) over the former, this rank's slice
    over the latter.  One instance serves every parameter of a model; the
    train step sets ``batch_dims`` for its batch."""

    def __init__(self, mesh, batch_dims: tuple = ()):
        super().__init__()
        self.mesh = mesh
        self.batch_dims = tuple(batch_dims)

    def forward(self, x):
        from torch.distributed.tensor import Partial, Replicate

        n = self.mesh.ndim
        grads = [Partial() if i in self.batch_dims else Replicate() for i in range(n)]
        return x.redistribute(self.mesh, [Replicate()] * n).to_local(grad_placements=grads)


def shard_lm(model: LM, mesh, specs: dict | None = None) -> LM:
    """Store ``model``'s parameters as DTensors on ``mesh`` (a
    ``DeviceMesh`` with named dimensions), each placed by the sanitized spec
    of its reference leaf (a stacked leaf's part takes the spec without the
    period axis) — from ``spec_lm``, or from ``specs``, a tree of the same
    shape (e.g. ``translate_specs`` of it: serving weights without FSDP),
    which the leaves then carry — and read each through a :class:`Gather`
    parametrization.  Every rank must hold the same full weights (each keeps
    its slice, with no communication).  Returns the model; its
    ``sharding`` is the :class:`Gather`, whose ``batch_dims`` start as the
    mesh's data-parallel axes (``DP_AXES``)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import DP_AXES

    if model.sharding is not None:
        raise ValueError("the model is sharded already")
    if specs is not None:
        model.param_specs = specs
    names = list(mesh.mesh_dim_names)
    gather = Gather(mesh, tuple(names.index(a) for a in DP_AXES if a in names))
    part_spec = {}
    for leaf in param_leaves(model):
        for p in leaf.parts:
            part_spec[id(p)] = P(*leaf.spec[1:]) if leaf.stacked else leaf.spec
    with torch.no_grad():
        for mod in list(model.modules()):
            for name, p in list(mod.named_parameters(recurse=False)):
                placements = named(part_spec[id(p)], p.shape, mesh)
                local = distribute_tensor(p.detach(), mesh, placements, src_data_rank=None)
                setattr(mod, name, nn.Parameter(local, requires_grad=p.requires_grad))
                # the gather keeps the shape and dtype: no check call (a collective)
                parametrize.register_parametrization(mod, name, gather, unsafe=True)
    model.sharding = gather
    return model


def init_lm(cfg: ArchConfig, *, generator: torch.Generator | None = None,
            device="cuda", dtype=None) -> LM:
    """A model with random weights drawn from ``generator`` (the reference's
    shapes, scales and distributions; not its values).  The generator must
    live on ``device``; without one, a CPU or CUDA generator seeded 0.  On
    the ``meta`` device (a dry run) nothing is drawn.
    ``dtype``: None for a serving model; ``cfg.param_dtype`` for a training
    model (the reference's ``init_lm``; see :class:`LM`)."""
    device = resolve_device(device)
    if device.type == "meta":  # shapes only: nothing to draw
        generator = None
    elif generator is None:
        generator = torch.Generator(device).manual_seed(0)
    with torch.no_grad():
        return LM(cfg, device=device, generator=generator, dtype=dtype)


def init_caches(cfg: ArchConfig, batch: int, seq: int, dtype=torch.bfloat16,
                device="cuda", *, src_len: int = 0) -> list[dict]:
    """Zero decode caches, one slot per layer, for ``seq`` positions and a
    context of ``src_len`` positions (``cross`` and ``dec`` layers)."""
    device = resolve_device(device)
    return [cache_position(kind, cfg, batch, seq, dtype, device, src_len=src_len)
            for _ in range(cfg.n_periods) for kind in cfg.period]


def encode(enc: Encoder, frames: torch.Tensor) -> torch.Tensor:
    """Bidirectional encoder over (stub) frame embeddings (B, T, d)."""
    x = frames.to(torch_dtype(enc.cfg.compute_dtype))
    for layer in enc.layers:
        y, _ = attention(layer.mixer, rms_norm(x, layer.norm1), causal=False, rope=True)
        x = x + y
        x = x + mlp(layer.ffn, rms_norm(x, layer.norm2))
    return rms_norm(x, enc.final_norm)


def _context(model: LM, cross_src) -> torch.Tensor | None:
    """The context the cross-attention layers read: ``cross_src`` on the
    model's device, run through the encoder for an encoder-decoder model."""
    if cross_src is None:
        if model.cfg.is_encdec:
            raise ValueError(f"{model.cfg.name} is an encoder-decoder: it needs cross_src")
        return None
    cross_src = torch.as_tensor(cross_src, device=model.device)
    return encode(model.encoder, cross_src) if model.cfg.is_encdec else cross_src


def _run(model: LM, x, mode: str, caches, ctx):
    aux = 0.0
    for i, block in enumerate(model.layers):
        x, _, a = apply_position(block, x, mode, None if caches is None else caches[i], ctx)
        aux = aux + a
    return x, aux


#: aten matrix products whose outputs the ``"dots"`` policy keeps (the
#: reference's ``jax.checkpoint_policies.checkpoint_dots``)
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.baddbmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat_policy: str | None):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant): recompute
    everything in the backward (policy None, ``"none"``, ``"nothing"``) or
    keep the matrix products' outputs (``"dots"``)."""
    if remat_policy in (None, "none", "nothing"):
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat_policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"unknown remat_policy {remat_policy!r}")


def _train_layers(model: LM, x, ctx, remat: bool, remat_policy: str | None):
    """The layers in train mode, period by period as the reference scans
    them: with ``remat``, each period under a checkpoint, and inside a
    period of several positions each position too (the reference's
    ``inner_remat``)."""
    n = len(model.cfg.period)

    def position(block, x):
        return apply_position(block, x, "train", None, ctx)[::2]

    def period(p, x):
        aux = 0.0
        for block in model.layers[p * n:(p + 1) * n]:
            fn = functools.partial(position, block)
            if remat and n > 1:
                fn = _remat(fn, remat_policy)
            x, a = fn(x)
            aux = aux + a
        return x, aux

    aux = 0.0
    for p in range(model.cfg.n_periods):
        fn = functools.partial(period, p)
        if remat:
            fn = _remat(fn, remat_policy)
        x, a = fn(x)
        aux = aux + a
    return x, aux


def lm_forward(model: LM, tokens: torch.Tensor, *, cross_src=None, remat: bool = True,
               remat_policy: str | None = None, dp_groups=()
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward over a full sequence: logits (B, S,
    padded_vocab) and the MoE load-balance aux loss summed over layers
    (float32; 0 without experts), both differentiable.  ``cross_src`` (B,
    S_src, d) is the context of a VLM or encoder-decoder model.  ``remat``
    recomputes each period (and each position of a multi-position period)
    in the backward instead of keeping its activations; ``remat_policy``
    ``"dots"`` keeps the matrix products' outputs.  Remat applies only
    where a gradient is being recorded.  ``dp_groups``: the process groups
    over which the global batch is split, ``tokens`` being this rank's rows
    (the MoE layers take their routing groups and aux loss over the global
    batch); none for the whole batch."""
    tokens = torch.as_tensor(tokens, device=model.device)
    x = embed(model.embed, tokens)
    ctx = {"positions": torch.arange(tokens.shape[1], device=model.device)[None, :],
           "cross_src": _context(model, cross_src), "dp_groups": tuple(dp_groups)}
    remat = remat and torch.is_grad_enabled() and any(
        p.requires_grad for p in model.parameters())
    x, aux = _train_layers(model, x, ctx, remat, remat_policy)
    logits = unembed(model.embed, rms_norm(x, model.final_norm))
    return logits, torch.as_tensor(aux, dtype=torch.float32, device=model.device)


@torch.no_grad()
def lm_prefill(model: LM, tokens: torch.Tensor, *, cross_src=None,
               cache_dtype=torch.bfloat16, max_seq: int | None = None
               ) -> tuple[torch.Tensor, list[dict]]:
    """Prefill: last-position logits (B, padded_vocab) and the filled decode
    caches, with capacity ``max_seq`` (>= S + the decode budget).  An
    encoder-decoder model encodes ``cross_src`` first; the context's K/V go
    into the ``cross`` and ``dec`` layers' slots."""
    tokens = torch.as_tensor(tokens, device=model.device)
    B, S = tokens.shape
    src = _context(model, cross_src)
    src_len = 0 if src is None else src.shape[1]
    caches = init_caches(model.cfg, B, max_seq or S, cache_dtype, model.device,
                         src_len=src_len)
    x = embed(model.embed, tokens)
    ctx = {"positions": torch.arange(S, device=model.device)[None, :], "cross_src": src}
    x, _ = _run(model, x, "prefill", caches, ctx)
    logits = unembed(model.embed, rms_norm(x[:, -1:], model.final_norm))
    return logits[:, 0], caches


def _capacity(caches: list[dict]) -> int | None:
    """Positions the self-attention KV caches hold (None without one)."""
    for slot in caches:
        if "kv" in slot:
            return slot["kv"].k.shape[1] * slot["kv"].k.shape[3]
    return None


@torch.no_grad()
def lm_decode(model: LM, caches: list[dict], token: torch.Tensor, position
              ) -> tuple[torch.Tensor, list[dict]]:
    """One decode step: logits (B, padded_vocab); ``caches`` is updated in
    place and returned.  ``position`` is the token's index in its sequence:
    an int for the whole batch, or one per row (continuous batching).  It
    must lie inside the KV caches (the reference would clamp the write)."""
    pos = position
    if not (isinstance(pos, torch.Tensor) and pos.device.type != "cpu"):
        pos = torch.as_tensor(np.asarray(pos), dtype=torch.int64)
        cap = _capacity(caches)
        if cap is not None and bool((pos < 0).any() or (pos >= cap).any()):
            raise IndexError(f"position {pos.tolist()} outside the caches' {cap} slots")
        pos = pos.to(model.device)
    token = torch.as_tensor(token, device=model.device)
    x = embed(model.embed, token[:, None])
    x, _ = _run(model, x, "decode", caches, {"decode_pos": pos})
    logits = unembed(model.embed, rms_norm(x, model.final_norm))
    return logits[:, 0], caches
