"""Optimizers: AdamW and Adafactor (factored second moment), functional
style — the port of ``repro/optim/optimizers.py``.

The optimizer walks the reference's pytree leaves
(``repro_torch.models.lm.param_leaves``): a leaf that the reference stacks
over periods has one stacked gradient and moment, so Adafactor's factoring
(by the stacked leaf's rank) and its RMS clip (over the whole leaf) are the
reference's; AdamW, being elementwise, writes each part of a parameter in
place through views.  Gradients and moments are lists with one float32 tensor per
leaf, on the parameters' device; the moments are updated in place.  The
operations follow the reference's order.  ``opt_state_specs`` is sharding
and waits for the distribution slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = [
    "OptState", "adamw_init", "adafactor_init", "make_optimizer", "global_norm",
    "clip_by_global_norm",
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
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in tree))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return [(g.to(torch.float32) * scale).to(g.dtype) for g in grads], norm


def _zeros_step(leaves) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=leaves[0].parts[0].device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(leaves) -> OptState:
    def zeros(leaf):
        return torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.parts[0].device)

    return OptState(step=_zeros_step(leaves), mu=[zeros(lf) for lf in leaves],
                    nu=[zeros(lf) for lf in leaves])


@torch.no_grad()
def _adamw_update(grads, state: OptState, leaves, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                  weight_decay=0.1) -> OptState:
    """One AdamW step: the parameters (``leaves``) and the moments in place;
    returns the state with its step advanced."""
    step = state.step + 1
    t = step.to(torch.float32)
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    for g, m, v, leaf in zip(grads, state.mu, state.nu, leaves):
        gf = g.to(torch.float32)
        m.copy_(b1 * m + (1 - b1) * gf)
        v.copy_(b2 * v + (1 - b2) * gf * gf)
        adam = (m / c1) / (torch.sqrt(v / c2) + eps)
        # elementwise, so each part is written in place through its view of
        # the leaf: no stacked copy of the parameters
        for p, a in zip(leaf.parts, leaf.views(adam)):
            delta = a + weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
    return OptState(step=step, mu=state.mu, nu=state.nu)


# ---------------------------------------------------------------------------
# Adafactor (no momentum, factored second moment for leaves of rank >= 2)
# ---------------------------------------------------------------------------

def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor_init(leaves) -> OptState:
    def nu0(leaf):
        shape, dev = leaf.shape, leaf.parts[0].device
        if _factored(shape):
            return {"row": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                    "col": torch.zeros(shape[:-2] + shape[-1:], dtype=torch.float32,
                                       device=dev)}
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    dev = leaves[0].parts[0].device
    return OptState(step=_zeros_step(leaves),
                    mu=[torch.zeros((), dtype=torch.float32, device=dev) for _ in leaves],  # stub
                    nu=[nu0(lf) for lf in leaves])


@torch.no_grad()
def _adafactor_update(grads, state: OptState, leaves, lr, *, decay=0.8, eps=1e-30,
                      weight_decay=0.0, clip_threshold=1.0) -> OptState:
    step = state.step + 1
    t = step.to(torch.float32)
    beta = 1.0 - t ** -decay
    for g, v, leaf in zip(grads, state.nu, leaves):
        gf = g.to(torch.float32)
        g2 = gf * gf + eps
        p = leaf.value()
        if _factored(p.shape):
            row = beta * v["row"] + (1 - beta) * g2.mean(dim=-1)
            col = beta * v["col"] + (1 - beta) * g2.mean(dim=-2)
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


def make_optimizer(name: str) -> tuple[Callable, Callable]:
    """Returns (init_fn(leaves) -> state, update_fn(grads, state, leaves, lr)
    -> state); the update writes the parameters in place."""
    if name == "adamw":
        return adamw_init, _adamw_update
    if name == "adafactor":
        return adafactor_init, _adafactor_update
    raise ValueError(f"unknown optimizer {name!r}")
