"""Input specs and placements for every (architecture x shape) cell — the
port of ``repro/launch/specs.py``.

``input_specs`` returns stand-ins for every model input: tensors on the
``meta`` device with the reference's shapes and dtypes (tokens ``int32``,
context ``bfloat16``), the port's counterpart of a ``ShapeDtypeStruct``.
``build_cell`` assembles everything a dry run or one real step needs: the
step function, its arguments (a sharded model, moments, batch, caches) and
the DTensor placements of each, in and out.

Shape cells (LM transformer shapes are seq_len x global_batch):

* train_4k     — seq 4096,   batch 256 (training; the train step)
* prefill_32k  — seq 32768,  batch 32  (inference prefill)
* decode_32k   — seq 32768,  batch 128 (one new token, KV cache of seq_len)
* long_500k    — seq 524288, batch 1   (long-context decode; SSM/hybrid only)

Modality stubs: [vlm]/[audio] context embeddings are precomputed
(B, n_ctx, d) tensors.  Enc-dec prefill applies seq_len to the *encoder*
(frames) and an 8x-shorter decoder prefix.

Placements follow the reference: parameters by ``spec_lm`` (pure-DP
architectures drop ``model``; serving drops FSDP, ``data`` and ``pod``),
moments by ``opt_state_specs``, the batch over the policy's data-parallel
axes, caches by :func:`_cache_specs`.  The port's caches are a list of
per-layer slot dicts (``repro_torch.models.lm.init_caches``), not
period-stacked trees, so their specs drop the period axis, as a stacked
parameter's part does.  The step runs the port's distribution: parameters
and moments are DTensors, the train step keeps this rank's rows of the
global batch, and serving computes each layer whole on every rank over
caches held whole (their placements are the reference's, for the memory
accounting).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.distributed.sharding import (DP_AXES, P, _mesh_axes, named, sanitize_tree,
                                              translate_specs)
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.lm import init_caches, init_lm, param_leaves, shard_lm, spec_lm
from repro_torch.optim import make_optimizer, opt_state_specs
from repro_torch.train.steps import (TrainHParams, make_decode_step, make_prefill_step,
                                     make_train_step)

__all__ = ["SHAPE_CELLS", "cell_applicable", "build_cell", "Cell", "input_specs",
           "policy_for", "default_hparams"]

SHAPE_CELLS = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def cell_applicable(cfg: ArchConfig, cell: str) -> tuple[bool, str]:
    if cell == "long_500k" and not cfg.supports_long_context:
        return False, (
            "pure full-attention arch: O(S^2) attention at 524288 requires a "
            "sub-quadratic mechanism this model does not have (DESIGN.md skip)"
        )
    return True, ""


@dataclasses.dataclass
class Cell:
    arch: str
    cell: str
    kind: str
    step: Any  # the step function: step(*args)
    args: tuple  # its arguments (meta tensors, or real ones on a device)
    in_shardings: tuple  # DTensor placements per argument leaf (None: whole on every rank)
    out_shardings: Any


def _dp_size(mesh) -> int:
    if mesh is None:
        return 1
    axes = _mesh_axes(mesh)
    return int(axes.get("pod", 1) * axes.get("data", 1))


def _cache_spec(name: str, batch_ok: bool, pure_dp: bool) -> P:
    """The reference's rule for one cache leaf, without its period axis.

    Batch shards over (pod, data) when divisible; otherwise (batch-1
    long-context) the KV-cache *sequence-block* axis shards over 'data'
    (flash-decode style).  Pure-DP archs shard sequence blocks over the
    otherwise-idle 'model' axis instead of kv heads."""
    bdim = DP_AXES if batch_ok else None
    head_dim = None if pure_dp else "model"
    if name in ("k", "v"):  # (B, nb, H, bs, D)
        nb_dim = "model" if pure_dp else (None if batch_ok else "data")
        return P(bdim, nb_dim, head_dim, None, None)
    if name == "state":  # (B, H, Pd, N)
        return P(bdim, head_dim, None, None)
    if name == "conv_x":  # (B, K-1, din)
        return P(bdim, None, head_dim)
    if name in ("conv_B", "conv_C"):
        return P(bdim, None, None)
    if name in ("cross_k", "cross_v"):  # (B, S_src, H, D)
        return P(bdim, None, head_dim, None)
    return P()


def _cache_specs(caches, batch: int, mesh, *, pure_dp: bool = False):
    """Specs for the port's decode caches (a list of per-layer slot dicts
    whose entries are ``KVCache``/``MambaCache`` dataclasses or tensors),
    a tree of the same structure: each leaf's spec by its name."""
    batch_ok = batch % _dp_size(mesh) == 0

    def walk(node, name=None):
        if isinstance(node, torch.Tensor):
            return _cache_spec(name, batch_ok, pure_dp)
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if dataclasses.is_dataclass(node):
            return dataclasses.replace(node, **{f.name: walk(getattr(node, f.name), f.name)
                                                for f in dataclasses.fields(node)})
        raise TypeError(f"a cache tree holds {type(node).__name__}")

    return walk(caches)


def input_specs(cfg: ArchConfig, cell: str) -> dict:
    """Meta-tensor stand-ins for the cell's model inputs."""
    info = SHAPE_CELLS[cell]
    seq, batch, kind = info["seq"], info["batch"], info["kind"]

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    tok = torch.int32
    out: dict[str, Any] = {}
    if kind == "train":
        out["tokens"] = spec((batch, seq), tok)
        if cfg.family == "vlm":
            out["context"] = spec((batch, cfg.n_context_tokens, cfg.d_model), torch.bfloat16)
        if cfg.is_encdec:
            out["context"] = spec((batch, seq, cfg.d_model), torch.bfloat16)
    elif kind == "prefill":
        dec_seq = seq
        if cfg.is_encdec:
            dec_seq = max(seq // 8, 128)
            out["context"] = spec((batch, seq, cfg.d_model), torch.bfloat16)
        elif cfg.family == "vlm":
            out["context"] = spec((batch, cfg.n_context_tokens, cfg.d_model), torch.bfloat16)
        out["tokens"] = spec((batch, dec_seq), tok)
    else:  # decode
        out["token"] = spec((batch,), tok)
        out["position"] = spec((), tok)
    return out


def policy_for(cfg: ArchConfig, cell: str) -> dict:
    """``use_mesh`` policy per (arch, cell): pure-DP archs fold 'model' into
    the batch axes; serving keeps activations on the training policy but
    the caller also strips FSDP from the weights (see build_cell)."""
    if cfg.parallelism == "dp":
        return {"dp_axes": ("pod", "data", "model"), "drop_axes": {"model"}}
    return {"dp_axes": DP_AXES, "drop_axes": frozenset()}


def default_hparams(cfg: ArchConfig) -> TrainHParams:
    """Per-arch training hyper-parameters for the production mesh: the
    largest models micro-batch via gradient accumulation so the per-device
    activation working set stays inside HBM."""
    accum = 4 if cfg.d_model >= 5120 else 1
    return TrainHParams(accum=accum)


def _draw(stand_in: torch.Tensor, vocab: int, generator, device) -> torch.Tensor:
    """A real input shaped like ``stand_in``: token ids below ``vocab``, or
    normal context embeddings."""
    if stand_in.dtype == torch.int32:
        return torch.randint(0, vocab, stand_in.shape, generator=generator, dtype=torch.int32,
                             device=device)
    return torch.randn(stand_in.shape, generator=generator, device=device).to(stand_in.dtype)


def build_cell(cfg: ArchConfig, cell: str, mesh, hp: TrainHParams | None = None, *,
               device="meta") -> Cell:
    """The cell's step, arguments and placements on ``mesh``.  With
    ``device="meta"`` every argument is abstract (a dry run); on a real
    device the weights and inputs are drawn from a ``torch.Generator``
    seeded 0, so one step can run.  Call it under
    ``use_mesh(mesh, **policy_for(cfg, cell))``, as the step runs.  With
    ``mesh=None`` the model stays unsharded and every placement is None:
    the single-device cell, the same weights and inputs."""
    info = SHAPE_CELLS[cell]
    seq, batch, kind = info["seq"], info["batch"], info["kind"]
    hp = hp or default_hparams(cfg)
    ins = input_specs(cfg, cell)
    pol = policy_for(cfg, cell)
    dp = pol["dp_axes"]
    device = torch.device(device)
    gen = None if device.type == "meta" else torch.Generator(device).manual_seed(0)
    if gen is not None:
        ins = {k: _draw(v, cfg.vocab, gen, device) if v.dim() else
               torch.tensor(seq // 2, dtype=torch.int32, device=device) for k, v in ins.items()}

    pspecs = spec_lm(cfg)
    if pol["drop_axes"]:  # pure-DP: weights lose their TP axes
        pspecs = translate_specs(pspecs, drop=pol["drop_axes"])
    if kind != "train":
        # serving weights are not FSDP-sharded: per-layer parameter
        # all-gathers have no business in a decode step
        pspecs = translate_specs(pspecs, drop=("data", "pod"))
    model = init_lm(cfg, generator=gen, device=device,
                    dtype=cfg.param_dtype if kind == "train" else None)
    if mesh is not None:  # None: one device, every rule a no-op (as the reference's)
        model = shard_lm(model, mesh, pspecs)
    leaves = param_leaves(model)
    psh = [named(leaf.spec, leaf.shape, mesh) for leaf in leaves]

    if kind == "train":
        opt = make_optimizer(cfg.optimizer)[0](leaves)
        ospecs = opt_state_specs([lf.spec for lf in leaves], [lf.shape for lf in leaves],
                                 cfg.optimizer)
        osh = sanitize_tree(ospecs, opt, mesh)
        bspec = {"tokens": P(dp, None),
                 **({"context": P(dp, None, None)} if "context" in ins else {})}
        bsh = sanitize_tree(bspec, ins, mesh)
        return Cell(cfg.name, cell, kind, make_train_step(cfg, hp), (model, opt, ins),
                    (psh, osh, bsh), (psh, osh, None))

    pure_dp = cfg.parallelism == "dp"
    logits_sh = named(P(DP_AXES, None if pure_dp else "model"), (batch, cfg.padded_vocab), mesh)
    if kind == "prefill":
        args = [model, ins["tokens"]]
        shardings = [psh, named(P(dp, None), ins["tokens"].shape, mesh)]
        if "context" in ins:
            args.append(ins["context"])
            shardings.append(named(P(dp, None, None), ins["context"].shape, mesh))
        dec_len = args[1].shape[1]
        src_len = ins["context"].shape[1] if "context" in ins else 0
        cache_abs = init_caches(cfg, batch, dec_len, device="meta", src_len=src_len)
        csh = sanitize_tree(_cache_specs(cache_abs, batch, mesh, pure_dp=pure_dp), cache_abs,
                            mesh)
        return Cell(cfg.name, cell, kind, make_prefill_step(cfg, max_seq=None), tuple(args),
                    tuple(shardings), (logits_sh, csh))

    # decode
    src_len = cfg.n_context_tokens if (cfg.family == "vlm" or cfg.is_encdec) else 0
    caches = init_caches(cfg, batch, seq, dtype=torch_dtype(cfg.kv_cache_dtype), device=device,
                         src_len=src_len)
    csh = sanitize_tree(_cache_specs(caches, batch, mesh, pure_dp=pure_dp), caches, mesh)
    tok_sh = named(P(DP_AXES), ins["token"].shape, mesh)
    pos_sh = named(P(), ins["position"].shape, mesh)
    return Cell(cfg.name, cell, kind, make_decode_step(cfg),
                (model, caches, ins["token"], ins["position"]),
                (psh, csh, tok_sh, pos_sh), (logits_sh, csh))
