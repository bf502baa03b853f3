"""Language models in PyTorch (dense / MoE / SSM / hybrid / VLM, and the
encoder-decoder) — the port of ``repro/models/lm.py`` for inference:
``init_lm``, ``init_caches``, ``encode``, ``lm_forward`` (forward only: no
remat, no gradient), ``lm_prefill`` and ``lm_decode``.

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
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core.cfa.api import resolve_device

from .blocks import apply_position, cache_position, ffn_kind, init_position
from .config import ArchConfig
from .layers import Embedding, _param, attention, embed, mlp, rms_norm, torch_dtype, unembed

__all__ = ["LM", "Encoder", "init_lm", "init_caches", "encode", "lm_forward", "lm_prefill",
           "lm_decode"]


class Encoder(nn.Module):
    """``enc_layers`` attention + MLP blocks and a final norm."""

    def __init__(self, cfg: ArchConfig, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            init_position("attn", "mlp", cfg, device=device, generator=generator)
            for _ in range(cfg.enc_layers))
        self.final_norm = _param(torch.ones(cfg.d_model, device=device))


class LM(nn.Module):
    """Embedding, ``n_layers`` blocks, final norm; the encoder when the
    configuration has one."""

    def __init__(self, cfg: ArchConfig, *, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = Embedding(cfg, device=device, generator=generator)
        self.layers = nn.ModuleList(
            init_position(kind, ffn_kind(cfg, i), cfg, device=device, generator=generator)
            for _ in range(cfg.n_periods) for i, kind in enumerate(cfg.period))
        self.final_norm = _param(torch.ones(cfg.d_model, device=device))
        if cfg.is_encdec:
            self.encoder = Encoder(cfg, device=device, generator=generator)

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
                device="cuda", *, src_len: int = 0) -> list[dict]:
    """Zero decode caches, one slot per layer, for ``seq`` positions and a
    context of ``src_len`` positions (``cross`` and ``dec`` layers)."""
    device = resolve_device(device)
    return [cache_position(kind, cfg, batch, seq, dtype, device, src_len=src_len)
            for _ in range(cfg.n_periods) for kind in cfg.period]


@torch.no_grad()
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


@torch.no_grad()
def lm_forward(model: LM, tokens: torch.Tensor, *, cross_src=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward over a full sequence: logits (B, S, padded_vocab) and the
    MoE load-balance aux loss summed over layers (float32; 0 without
    experts).  ``cross_src`` (B, S_src, d) is the context of a VLM or
    encoder-decoder model."""
    tokens = torch.as_tensor(tokens, device=model.device)
    x = embed(model.embed, tokens)
    ctx = {"positions": torch.arange(tokens.shape[1], device=model.device)[None, :],
           "cross_src": _context(model, cross_src)}
    x, aux = _run(model, x, "train", None, ctx)
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
