"""Entry points: train_step / prefill_step / decode_step builders — the port
of ``repro/train/steps.py``.

``make_train_step`` builds ``(model, opt_state, batch) -> (model, opt_state,
metrics)``: the loss's gradients by autograd (through the hand-written
``ssd_scan`` backward kernel on CUDA), optional error-feedback compression,
global-norm clipping, the cosine schedule and the optimizer, which updates
the model's parameters in place.

Under an active mesh (``repro_torch.distributed.sharding.use_mesh``) the
model must be sharded on it (``repro_torch.models.lm.shard_lm``).  The step
takes the global batch and keeps this rank's rows of every entry: those of
its coordinate over the mesh dimensions that ``batch_spec()`` splits dim 0
over.  The loss of those rows is divided by their number of shards before
the backward, whose gradients are summed across them by the parameters'
gathers (a reduce-scatter), so the step gives the single-device step's
loss, ``ce``, ``aux``, ``grad_norm`` and update on the global batch; the
logged loss and ``ce`` are the means over the shards.  ``shard_grads``
keeps each gradient on its parameter's placements (the reference's
``constrain_tree``: ZeRO); without it the gradients are replicated (the
all-reduce's result) and the update gives the same numbers.

Under an installed recorder (``Trainer(recorder=...)``) the
step records ``train.forward`` (``loss_fn`` whole) with its child
``train.loss`` (the cross entropy from the logits), ``train.backward`` (the
backward and the gradients' collection), ``train.clip`` and
``train.optimizer`` (the learning rate and the update).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import runtime
from repro_torch.distributed.compression import ef_compress, ef_init
from repro_torch.distributed.sharding import P, batch_spec, constrain_tree, get_mesh, named
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import LM, lm_decode, lm_forward, lm_prefill, param_leaves
from repro_torch.optim import clip_by_global_norm, cosine_warmup, make_optimizer

__all__ = ["TrainHParams", "loss_fn", "make_train_step", "make_prefill_step",
           "make_decode_step"]


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    peak_lr: float = 3e-4
    warmup: int = 200
    total_steps: int = 10_000
    clip_norm: float = 1.0
    aux_coef: float = 0.01  # MoE load-balance loss coefficient
    accum: int = 1  # gradient-accumulation microbatches
    remat: bool = True
    remat_policy: str = "none"  # none | dots | nothing
    shard_grads: bool = True  # pin grads to param sharding (ZeRO reduce-scatter)
    compress_grads: bool = False  # int8 error-feedback DP compression

    def policy(self) -> str | None:
        """``lm_forward``'s ``remat_policy`` (None: recompute everything)."""
        return None if self.remat_policy == "none" else self.remat_policy


def loss_fn(model: LM, batch: dict, cfg: ArchConfig, hp: TrainHParams, *, dp_groups=()):
    """Next-token cross entropy (padded-vocab masked) + MoE aux loss, in the
    reference's form: the padded vocab is an additive row of -1e30, the
    target is picked by a masked sum.  ``dp_groups``: see ``lm_forward``
    (the cross entropy is this rank's rows' mean)."""
    rec = runtime.active()
    with runtime.train_span(rec, "train.forward"):
        tokens = batch["tokens"]  # (B, S)
        logits, aux = lm_forward(model, tokens, cross_src=batch.get("context"),
                                 remat=hp.remat, remat_policy=hp.policy(), dp_groups=dp_groups)
        with runtime.train_span(rec, "train.loss"):
            tokens = torch.as_tensor(tokens, device=logits.device)
            lf = logits[:, :-1]
            targets = tokens[:, 1:]
            vp = cfg.padded_vocab
            vocab_ids = torch.arange(vp, device=lf.device)[None, None, :]
            pad_mask = torch.where(vocab_ids >= cfg.vocab, -1e30, 0.0).to(torch.float32)
            lf = lf.to(torch.float32) + pad_mask
            m = lf.amax(dim=-1, keepdim=True).detach()
            shifted = lf - m
            lse = torch.log(torch.sum(torch.exp(shifted), dim=-1)) + m[..., 0]
            picked = torch.sum(torch.where(vocab_ids == targets[..., None], shifted, 0.0),
                               dim=-1) + m[..., 0]
            ce = (lse - picked).mean()
            return ce + hp.aux_coef * aux, {"ce": ce, "aux": aux}


def _local_rows(batch: dict, mesh) -> tuple[dict, tuple]:
    """This rank's rows of every batch entry, and the mesh dimensions that
    split them (``batch_spec()`` sanitized for the batch; row-major over
    those dimensions, as a DTensor sharded there lays them out)."""
    from torch.distributed.tensor import Shard

    rows = {int(v.shape[0]) for v in batch.values()}
    if len(rows) != 1:
        raise ValueError(f"batch entries disagree on the batch size: {sorted(rows)}")
    (B,) = rows
    placements = named(batch_spec(), (B,), mesh)
    dims = tuple(i for i, pl in enumerate(placements) if isinstance(pl, Shard))
    coord = mesh.get_coordinate()
    index, n = 0, 1
    for d in dims:
        index, n = index * mesh.size(d) + coord[d], n * mesh.size(d)
    per = B // n
    return {k: v[index * per:(index + 1) * per] for k, v in batch.items()}, dims


def _mean_over(t: torch.Tensor, groups, n: int) -> torch.Tensor:
    """The mean of ``t`` over the ranks of ``groups`` (``n`` in all)."""
    import torch.distributed as dist

    t = t.clone()
    for g in groups:
        dist.all_reduce(t, group=g)
    return t / n


def _grads(model: LM, batch: dict, cfg: ArchConfig, hp: TrainHParams, leaves, mesh):
    """(loss, metrics, one gradient per leaf) for one batch; under ``mesh``
    of this rank's rows, with the loss and ``ce`` averaged over the shards
    and the gradients summed over them."""
    for leaf in leaves:
        for p in leaf.parts:
            p.grad = None
    groups = ()
    if mesh is not None:
        batch, dims = _local_rows(batch, mesh)
        model.sharding.batch_dims = dims
        groups = tuple(mesh.get_group(d) for d in dims)
    n = math.prod(g.size() for g in groups)
    loss, metrics = loss_fn(model, batch, cfg, hp, dp_groups=groups)
    with runtime.train_span(runtime.active(), "train.backward"):
        (loss / n).backward()
        loss, metrics = loss.detach(), {k: v.detach() for k, v in metrics.items()}
        if groups:
            loss = _mean_over(loss, groups, n)
            metrics["ce"] = _mean_over(metrics["ce"], groups, n)  # aux is global already
        return loss, metrics, [leaf.take_grad() for leaf in leaves]


def make_train_step(cfg: ArchConfig, hp: TrainHParams = TrainHParams()):
    """(model, opt_state, batch) -> (model, opt_state, metrics); the model's
    parameters are updated in place.  Under an active mesh the model must
    be sharded on it and ``batch`` is the global batch."""
    _, opt_update = make_optimizer(cfg.optimizer)

    def train_step(model: LM, opt_state, batch: dict):
        mesh = get_mesh()
        placed = None if model.sharding is None else model.sharding.mesh
        if placed is not mesh:
            raise ValueError(f"the model is sharded on {placed} and the active mesh is {mesh}: "
                             f"under a mesh the step takes a model sharded on it (shard_lm)")
        leaves = param_leaves(model)
        if hp.accum > 1:
            grads, loss = None, 0.0
            for i in range(hp.accum):
                mb = {k: v.reshape(hp.accum, v.shape[0] // hp.accum, *v.shape[1:])[i]
                      for k, v in batch.items()}
                l, _, g = _grads(model, mb, cfg, hp, leaves, mesh)
                grads = [gi.to(torch.float32) for gi in g] if grads is None else \
                    [a + b for a, b in zip(grads, g)]
                loss = loss + l
            grads = [g / hp.accum for g in grads]
            loss = loss / hp.accum
            metrics = {}
        else:
            loss, metrics, grads = _grads(model, batch, cfg, hp, leaves, mesh)
        if mesh is not None:
            # the gathers' backward left each gradient on its parameter's
            # placements (the reduce-scatter); replicated without shard_grads
            grads = constrain_tree(grads, [leaf.spec if hp.shard_grads else P()
                                           for leaf in leaves])
        if hp.compress_grads:
            # stateless form, as the reference's step: the residual is dropped
            grads, _ = ef_compress(grads, ef_init(grads))
        rec = runtime.active()
        with runtime.train_span(rec, "train.clip"):
            grads, gnorm = clip_by_global_norm(grads, hp.clip_norm)
        with runtime.train_span(rec, "train.optimizer"):
            lr = cosine_warmup(opt_state.step, peak_lr=hp.peak_lr, warmup=hp.warmup,
                               total=hp.total_steps)
            opt_state = opt_update(grads, opt_state, leaves, lr)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return model, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, *, max_seq: int | None = None):
    def prefill_step(model: LM, tokens, context=None):
        return lm_prefill(model, tokens, cross_src=context, max_seq=max_seq)

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    def decode_step(model: LM, caches, token, position):
        return lm_decode(model, caches, token, position)

    return decode_step
