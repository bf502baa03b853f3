"""Optimizers: AdamW and Adafactor (factored second moment), functional
style — the port of ``repro/optim/optimizers.py``.

The optimizer walks the reference's pytree leaves
(``repro_torch.models.lm.param_leaves``): a leaf that the reference stacks
over periods has one stacked gradient and moment, so Adafactor's factoring
(by the stacked leaf's rank) and its RMS clip (over the whole leaf) are the
reference's; AdamW, being elementwise, writes each part of a parameter in
place through views.  Gradients and moments are lists with one float32 tensor per
leaf, on the parameters' device; the moments are updated in place.  The
operations follow the reference's order.

On a sharded model (``repro_torch.models.lm.shard_lm``) the parameters,
gradients and moments are DTensors: the moments are made with the
placements of :func:`opt_state_specs` (ZeRO: a moment shards like its
parameter; Adafactor's factored ``row``/``col`` drop the reduced dim's axis).
AdamW, elementwise, updates each rank's shards alone; Adafactor runs its
operations on the DTensors, which reduce across ranks where a mean spans a
sharded dimension.  :func:`global_norm` sums the squares of every leaf's
shards before its square root.  The step counter stays a plain tensor on
every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.distributed.sharding import P, full_tensor, named

__all__ = [
    "OptState", "adamw_init", "adafactor_init", "make_optimizer", "opt_state_specs",
    "global_norm", "clip_by_global_norm",
]


@dataclasses.dataclass
class OptState:
    step: torch.Tensor  # int32 0-d
    mu: list  # first moment per leaf (AdamW) or a float32 0-d stub per leaf (Adafactor)
    nu: list  # second moment per leaf; Adafactor: dict(row=, col=) for leaves of rank >= 2

    def tensors(self) -> list[torch.Tensor]:
        """Every tensor of the state in the reference's flatten order: step,
        the mu leaves, the nu leaves (a factored leaf's ``col`` before its
        ``row``)."""
        nu = []
        for v in self.nu:
            nu += [v["col"], v["row"]] if isinstance(v, dict) else [v]
        return [self.step, *self.mu, *nu]

    def load(self, tensors: list[torch.Tensor]) -> None:
        """Copy ``tensors`` (the order of :meth:`tensors`) into the state, in
        place."""
        mine = self.tensors()
        if len(tensors) != len(mine):
            raise ValueError(f"{len(tensors)} tensors for an optimizer state of {len(mine)}")
        with torch.no_grad():
            for dst, src in zip(mine, tensors):
                dst.copy_(src)


def global_norm(tree: list[torch.Tensor]) -> torch.Tensor:
    """The L2 norm over every leaf (a plain 0-d tensor; on DTensor leaves
    the per-shard sums are reduced across ranks before the square root)."""
    return torch.sqrt(full_tensor(sum(torch.sum(torch.square(g.to(torch.float32)))
                                      for g in tree)))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return [(g.to(torch.float32) * scale).to(g.dtype) for g in grads], norm


def _zeros_step(leaves) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=leaves[0].parts[0].device)


def _mesh(leaves):
    """The mesh of a sharded model's leaves (None for plain parameters)."""
    return getattr(leaves[0].parts[0], "device_mesh", None)


def _zeros(shape, spec: P, mesh, device) -> torch.Tensor:
    """float32 zeros: plain, or a DTensor laid out by ``spec`` on ``mesh``."""
    if mesh is None:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    from torch.distributed.tensor import distribute_tensor, zeros

    placements = named(spec, shape, mesh)
    if device.type == "meta":  # a dry run's parameters: shards on meta, not the mesh's device
        return distribute_tensor(torch.zeros(shape, dtype=torch.float32, device=device), mesh,
                                 placements, src_data_rank=None)
    return zeros(shape, dtype=torch.float32, device_mesh=mesh, placements=placements)


def _moments(leaves, optimizer: str) -> OptState:
    """Zero moments per :func:`opt_state_specs` (placed on a sharded
    model's mesh); the step a plain int32 0."""
    specs = opt_state_specs([lf.spec for lf in leaves], [lf.shape for lf in leaves], optimizer)
    mesh, dev = _mesh(leaves), leaves[0].parts[0].device

    def make(spec, shape):
        return _zeros(shape, spec, mesh, dev)

    def nu(spec, leaf):
        if isinstance(spec, dict):
            shape = leaf.shape
            return {"row": make(spec["row"], shape[:-1]),
                    "col": make(spec["col"], shape[:-2] + shape[-1:])}
        return make(spec, leaf.shape)

    mu = [make(s, lf.shape if optimizer == "adamw" else ()) for s, lf in zip(specs.mu, leaves)]
    return OptState(step=_zeros_step(leaves), mu=mu,
                    nu=[nu(s, lf) for s, lf in zip(specs.nu, leaves)])


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (a view: writes reach the DTensor)."""
    return t.to_local() if hasattr(t, "to_local") else t


def _like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` with ``ref``'s placements where both are DTensors."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor) and t.placements != ref.placements:
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(leaves) -> OptState:
    return _moments(leaves, "adamw")


@torch.no_grad()
def _adamw_update(grads, state: OptState, leaves, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                  weight_decay=0.1) -> OptState:
    """One AdamW step: the parameters (``leaves``) and the moments in place;
    returns the state with its step advanced."""
    step = state.step + 1
    t = step.to(torch.float32)
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    for g, m, v, leaf in zip(grads, state.mu, state.nu, leaves):
        # elementwise: on DTensors laid out alike, each rank's shards alone
        gf, m, v = (_local(x) for x in (_like(g.to(torch.float32), m), m, v))
        m.copy_(b1 * m + (1 - b1) * gf)
        v.copy_(b2 * v + (1 - b2) * gf * gf)
        adam = (m / c1) / (torch.sqrt(v / c2) + eps)
        # each part is written in place through its view of the leaf: no
        # stacked copy of the parameters
        for p, a in zip(map(_local, leaf.parts), leaf.views(adam)):
            delta = a + weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
    return OptState(step=step, mu=state.mu, nu=state.nu)


# ---------------------------------------------------------------------------
# Adafactor (no momentum, factored second moment for leaves of rank >= 2)
# ---------------------------------------------------------------------------

def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor_init(leaves) -> OptState:
    return _moments(leaves, "adafactor")  # mu: a 0-d stub per leaf


@torch.no_grad()
def _adafactor_update(grads, state: OptState, leaves, lr, *, decay=0.8, eps=1e-30,
                      weight_decay=0.0, clip_threshold=1.0) -> OptState:
    step = state.step + 1
    t = step.to(torch.float32)
    beta = 1.0 - t ** -decay
    for g, v, leaf in zip(grads, state.nu, leaves):
        p = leaf.value()
        gf = _like(g.to(torch.float32), p)
        g2 = gf * gf + eps
        if _factored(p.shape):
            # on DTensors the means over a sharded dim reduce across ranks;
            # the moments keep their opt_state_specs placements
            row = _like(beta * v["row"] + (1 - beta) * g2.mean(dim=-1), v["row"])
            col = _like(beta * v["col"] + (1 - beta) * g2.mean(dim=-2), v["col"])
            denom = torch.clamp(row.mean(dim=-1, keepdim=True), min=eps)
            rfac = torch.rsqrt(row / denom)[..., None]  # (..., rows, 1)
            cfac = torch.rsqrt(col)[..., None, :]  # (..., 1, cols)
            update = gf * rfac * cfac
            v["row"].copy_(row)
            v["col"].copy_(col)
        else:
            v.copy_(beta * v + (1 - beta) * g2)
            update = gf * torch.rsqrt(v)
        rms = torch.sqrt(torch.mean(update * update))
        update = update / torch.clamp(rms / clip_threshold, min=1.0)
        if weight_decay:
            update = update + weight_decay * p.to(torch.float32)
        leaf.assign((p.to(torch.float32) - lr * update).to(p.dtype))
    return OptState(step=step, mu=state.mu, nu=state.nu)


def opt_state_specs(param_specs: list, params_shapes: list, optimizer: str) -> OptState:
    """The moments' logical specs, one per leaf as ``OptState`` holds them,
    from the leaves' specs and shapes (``ParamLeaf.spec``/``.shape``, or
    anything with a ``shape``): ZeRO, a moment shards like its parameter;
    Adafactor's factored moments drop the reduced dim's axis (``row`` the
    last, ``col`` the one before) and its ``mu`` stubs are replicated."""
    if optimizer == "adamw":
        return OptState(step=P(), mu=list(param_specs), nu=list(param_specs))

    def nu_spec(spec, shp):
        shape = shp.shape if hasattr(shp, "shape") else shp
        if len(shape) >= 2:
            dims = list(spec) + [None] * (len(shape) - len(spec))
            return {"row": P(*dims[:-1]), "col": P(*(dims[:-2] + dims[-1:]))}
        return spec

    return OptState(step=P(), mu=[P() for _ in param_specs],
                    nu=[nu_spec(s, sh) for s, sh in zip(param_specs, params_shapes)])


def make_optimizer(name: str) -> tuple[Callable, Callable]:
    """Returns (init_fn(leaves) -> state, update_fn(grads, state, leaves, lr)
    -> state); the update writes the parameters in place."""
    if name == "adamw":
        return adamw_init, _adamw_update
    if name == "adafactor":
        return adafactor_init, _adafactor_update
    raise ValueError(f"unknown optimizer {name!r}")
