"""Decoder-only language model in PyTorch — the port of
``repro/models/lm.py`` for inference: ``init_lm``, ``init_caches``,
``lm_forward`` (forward only: no remat, no gradient), ``lm_prefill`` and
``lm_decode``.

The reference stacks the parameters of its repeated period and scans over
them; here each layer is its own ``Block`` in ``LM.layers`` (layer
``p * len(period) + i`` is period ``p``'s position ``i``) and owns its own
cache tensors: ``caches`` is a list with one slot dict per layer,
``{"kv": KVCache}`` or ``{"ssm": MambaCache}``.  ``lm_prefill`` and
``lm_decode`` write the caches in place.

Every entry point runs on the CUDA device unless the caller asks for the
CPU (``device="cpu"``), where the kernels run their plain versions.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core.cfa.api import resolve_device

from .blocks import apply_position, cache_position, check_supported, ffn_kind, init_position
from .config import ArchConfig
from .layers import Embedding, _param, embed, rms_norm, unembed

__all__ = ["LM", "init_lm", "init_caches", "lm_forward", "lm_prefill", "lm_decode"]


class LM(nn.Module):
    """Embedding, ``n_layers`` blocks, final norm."""

    def __init__(self, cfg: ArchConfig, *, device="cuda", generator=None):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = Embedding(cfg, device=device, generator=generator)
        self.layers = nn.ModuleList(
            init_position(kind, ffn_kind(cfg, i), cfg, device=device, generator=generator)
            for _ in range(cfg.n_periods) for i, kind in enumerate(cfg.period))
        self.final_norm = _param(torch.ones(cfg.d_model, device=device))

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


def init_lm(cfg: ArchConfig, *, generator: torch.Generator | None = None,
            device="cuda") -> LM:
    """A model with random weights drawn from ``generator`` (the reference's
    shapes, scales and distributions; not its values).  The generator must
    live on ``device``; without one, a CPU or CUDA generator seeded 0."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    with torch.no_grad():
        return LM(cfg, device=device, generator=generator)


def init_caches(cfg: ArchConfig, batch: int, seq: int, dtype=torch.bfloat16,
                device="cuda") -> list[dict]:
    """Zero decode caches, one slot per layer, for ``seq`` positions."""
    device = resolve_device(device)
    return [cache_position(kind, cfg, batch, seq, dtype, device)
            for _ in range(cfg.n_periods) for kind in cfg.period]


def _run(model: LM, x, mode: str, caches, ctx):
    for i, block in enumerate(model.layers):
        x, _ = apply_position(block, x, mode, None if caches is None else caches[i], ctx)
    return x


@torch.no_grad()
def lm_forward(model: LM, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward over a full sequence: logits (B, S, padded_vocab) and the
    auxiliary loss (0: no experts in the ported families)."""
    tokens = torch.as_tensor(tokens, device=model.device)
    x = embed(model.embed, tokens)
    ctx = {"positions": torch.arange(tokens.shape[1], device=model.device)[None, :]}
    x = _run(model, x, "train", None, ctx)
    logits = unembed(model.embed, rms_norm(x, model.final_norm))
    return logits, torch.zeros((), device=model.device)


@torch.no_grad()
def lm_prefill(model: LM, tokens: torch.Tensor, *, cache_dtype=torch.bfloat16,
               max_seq: int | None = None) -> tuple[torch.Tensor, list[dict]]:
    """Prefill: last-position logits (B, padded_vocab) and the filled decode
    caches, with capacity ``max_seq`` (>= S + the decode budget)."""
    tokens = torch.as_tensor(tokens, device=model.device)
    B, S = tokens.shape
    caches = init_caches(model.cfg, B, max_seq or S, cache_dtype, model.device)
    x = embed(model.embed, tokens)
    ctx = {"positions": torch.arange(S, device=model.device)[None, :]}
    x = _run(model, x, "prefill", caches, ctx)
    logits = unembed(model.embed, rms_norm(x[:, -1:], model.final_norm))
    return logits[:, 0], caches


def _capacity(caches: list[dict]) -> int | None:
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
    x = _run(model, x, "decode", caches, {"decode_pos": pos})
    logits = unembed(model.embed, rms_norm(x, model.final_norm))
    return logits[:, 0], caches
