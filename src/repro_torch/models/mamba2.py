"""Mamba2 (SSD) block in PyTorch: chunked state-space scan with facet state
passing — the port of ``repro/models/mamba2.py`` for inference.

The sequence is tiled into chunks; the inter-chunk SSM state is the chunk's
CFA flow-out facet.  The training forward and prefill run the hand-written
``ssd_scan`` kernel (its plain version on the CPU) once — prefill for both
the block's output and the decode cache's final state; training
differentiates it through the hand-written backward kernel.  Decode carries
a constant-size cache — the SSM state plus the causal-conv tails — and is
one ``ssd_decode_step`` per token in plain PyTorch (the reference has no
kernel for it either).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import P
from repro_torch.kernels.mamba_gate import gated_rms_norm
from repro_torch.kernels.ssd import ssd_decode_step, ssd_scan
from repro_torch.runtime import resolve_device

from .config import ArchConfig
from .layers import _cd, _normal, _param, rms_norm, silu, spec_norm

__all__ = ["Mamba2", "spec_mamba", "mamba_train", "mamba_prefill", "mamba_decode",
           "MambaCache"]


@dataclasses.dataclass
class MambaCache:
    """Decode cache: conv tails + SSM state (the running facet)."""

    conv_x: torch.Tensor  # (B, K-1, d_inner)
    conv_B: torch.Tensor  # (B, K-1, N)
    conv_C: torch.Tensor  # (B, K-1, N)
    state: torch.Tensor  # (B, H, P, N) float32

    @staticmethod
    def zeros(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
              device="cuda") -> "MambaCache":
        """Zeros on ``device``: the CUDA device unless the caller asks for
        the CPU (a missing card raises)."""
        device = resolve_device(device)
        K, din, n = cfg.ssm_conv, cfg.ssm_d_inner, cfg.ssm_state
        h, pd = cfg.ssm_heads, cfg.ssm_head_dim
        return MambaCache(
            torch.zeros((batch, K - 1, din), dtype=dtype, device=device),
            torch.zeros((batch, K - 1, n), dtype=dtype, device=device),
            torch.zeros((batch, K - 1, n), dtype=dtype, device=device),
            torch.zeros((batch, h, pd, n), dtype=torch.float32, device=device),
        )


class Mamba2(nn.Module):
    """SSD mixer weights: the projections and conv kernels in ``dtype``
    (default: the compute dtype), with ``ssm_conv_bias`` a bias per filter
    (``conv_x_bias``, ``conv_B_bias``, ``conv_C_bias``, zeros at init);
    ``dt_bias``, ``A_log``, ``D`` and the norm scale in float32."""

    def __init__(self, cfg: ArchConfig, *, device="cuda", generator=None, dtype=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        d, din, n, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
        K = cfg.ssm_conv
        cd = dtype or _cd(cfg)
        # (name, shape, init scale) in the reference's order
        self._mats = [("w_x", (d, din), d ** -0.5), ("w_z", (d, din), d ** -0.5),
                      ("w_B", (d, n), d ** -0.5), ("w_C", (d, n), d ** -0.5),
                      ("w_dt", (d, h), d ** -0.5), ("conv_x", (K, din), K ** -0.5),
                      ("conv_B", (K, n), K ** -0.5), ("conv_C", (K, n), K ** -0.5),
                      ("w_out", (din, d), din ** -0.5)]
        for name, shape, _ in self._mats:
            setattr(self, name, _param(torch.zeros(shape, dtype=cd, device=device)))
        if cfg.ssm_conv_bias:
            for name, width in (("conv_x_bias", din), ("conv_B_bias", n), ("conv_C_bias", n)):
                setattr(self, name, _param(torch.zeros(width, dtype=cd, device=device)))
        self.dt_bias = _param(torch.zeros(h, device=device))
        self.A_log = _param(torch.zeros(h, device=device))  # a = -exp(A_log) = -1
        self.D = _param(torch.ones(h, device=device))
        self.norm = _param(torch.ones(din, device=device))
        if generator is not None:
            with torch.no_grad():
                for name, shape, scale in self._mats:
                    w = getattr(self, name)
                    w.copy_(_normal(shape, scale, w.dtype, generator, w.device))


def spec_mamba(cfg: ArchConfig) -> dict:
    """The reference's logical specs of the mixer's weights (and the port's
    conv biases)."""
    s = {
        "w_x": P("data", "model"),
        "w_z": P("data", "model"),
        "w_B": P("data", None),
        "w_C": P("data", None),
        "w_dt": P("data", "model"),
        "dt_bias": P(None),
        "A_log": P(None),
        "D": P(None),
        "conv_x": P(None, "model"),
        "conv_B": P(None, None),
        "conv_C": P(None, None),
        "norm": spec_norm(),
        "w_out": P("model", "data"),
    }
    if cfg.ssm_conv_bias:
        s.update(conv_x_bias=P("model"), conv_B_bias=P(None), conv_C_bias=P(None))
    return s


def _causal_conv(x: torch.Tensor, w: torch.Tensor, tail: torch.Tensor | None = None,
                 bias: torch.Tensor | None = None):
    """Depthwise causal conv via K shifted adds, summed in order in x's dtype,
    plus ``bias`` (C,) where there is one, then SiLU.  x: (B,S,C); w: (K,C).
    ``tail``: (B, K-1, C) history for decode."""
    K = w.shape[0]
    w = w.to(x.dtype)
    if tail is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([tail.to(x.dtype), x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S, :] * w[0][None, None, :]
    for j in range(1, K):
        out = out + xp[:, j:j + S, :] * w[j][None, None, :]
    if bias is not None:
        out = out + bias.to(x.dtype)
    return silu(out)


def _conv_bias(m: Mamba2, name: str) -> torch.Tensor | None:
    return getattr(m, f"{name}_bias") if m.cfg.ssm_conv_bias else None


def _projections(m: Mamba2, x: torch.Tensor):
    cd = _cd(m.cfg)
    xc = x.to(cd)
    return tuple(xc @ w.to(cd) for w in (m.w_x, m.w_z, m.w_B, m.w_C, m.w_dt))  # xi, z, B, C, dt


def _decays(m: Mamba2, dt: torch.Tensor):
    v = dt.float() + m.dt_bias
    dtp = torch.logaddexp(v, torch.zeros_like(v))  # softplus, (B,S,H)
    return -torch.exp(m.A_log)[None, None, :] * dtp, dtp


def _ssd(xh, loga, Bm, Cm, chunk: int):
    """The SSD over a sequence of any length: zero-pad to a multiple of
    L = min(chunk, T) (loga = 0 and x = 0 leave the state untouched), one
    ``ssd_scan`` launch, crop."""
    T = xh.shape[1]
    L = min(chunk, T)
    pad = (-T) % L
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        loga = F.pad(loga, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    y, state = ssd_scan(xh, loga, Bm, Cm, chunk=L)
    return y[:, :T].contiguous(), state  # the epilogue kernel takes whole rows


def _mamba_full(m: Mamba2, x: torch.Tensor):
    """The full-sequence block: (output, raw projections xi/B/C, final state)."""
    cfg = m.cfg
    B, S, _ = x.shape
    h, pd = cfg.ssm_heads, cfg.ssm_head_dim
    xi, z, Bm, Cm, dt = _projections(m, x)
    xi_c = _causal_conv(xi, m.conv_x, bias=_conv_bias(m, "conv_x"))
    Bm_c = _causal_conv(Bm, m.conv_B, bias=_conv_bias(m, "conv_B"))
    Cm_c = _causal_conv(Cm, m.conv_C, bias=_conv_bias(m, "conv_C"))
    loga, dtp = _decays(m, dt)
    xh = xi_c.reshape(B, S, h, pd) * dtp[..., None].to(xi_c.dtype)
    y, state = _ssd(xh, loga, Bm_c, Cm_c, cfg.ssm_chunk)
    y = gated_rms_norm(y, xh, z, m.D, m.norm)
    cd = _cd(cfg)
    return y.to(cd) @ m.w_out.to(cd), (xi, Bm, Cm), state


def mamba_train(m: Mamba2, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD block (train forward / prefill)."""
    return _mamba_full(m, x)[0]


def mamba_prefill(m: Mamba2, x: torch.Tensor, cache: MambaCache) -> tuple[torch.Tensor, MambaCache]:
    """The full-sequence block plus its decode cache, written in place: the
    last K-1 raw projections as conv tails and the scan's final state — both
    from the one ``ssd_scan`` launch (the reference runs the scan twice)."""
    S, K = x.shape[1], m.cfg.ssm_conv
    if S < K - 1:
        raise ValueError(f"a prefill needs at least {K - 1} tokens for the conv tails, got {S}")
    out, raw, state = _mamba_full(m, x)
    for dst, r in zip((cache.conv_x, cache.conv_B, cache.conv_C), raw):
        dst.copy_(r[:, S - (K - 1):, :])
    cache.state.copy_(state)
    return out, cache


def mamba_decode(m: Mamba2, x: torch.Tensor, cache: MambaCache) -> tuple[torch.Tensor, MambaCache]:
    """One-token SSD step; O(1) state update (the facet, degenerate chunk).
    Updates ``cache`` in place and returns it."""
    cfg = m.cfg
    B = x.shape[0]
    h, pd = cfg.ssm_heads, cfg.ssm_head_dim
    xi, z, Bm, Cm, dt = _projections(m, x)
    xi_c = _causal_conv(xi, m.conv_x, tail=cache.conv_x, bias=_conv_bias(m, "conv_x"))
    Bm_c = _causal_conv(Bm, m.conv_B, tail=cache.conv_B, bias=_conv_bias(m, "conv_B"))
    Cm_c = _causal_conv(Cm, m.conv_C, tail=cache.conv_C, bias=_conv_bias(m, "conv_C"))
    for tail, new in ((cache.conv_x, xi), (cache.conv_B, Bm), (cache.conv_C, Cm)):
        tail.copy_(torch.cat([tail[:, 1:], new.to(tail.dtype)], dim=1))
    loga, dtp = _decays(m, dt)  # (B,1,H)
    xh = xi_c.reshape(B, 1, h, pd) * dtp[..., None].to(xi_c.dtype)
    y, state = ssd_decode_step(cache.state, xh[:, 0].float(), loga[:, 0], Bm_c[:, 0], Cm_c[:, 0])
    cache.state.copy_(state)
    y = y[:, None] + m.D[None, None, :, None] * xh.float()
    y = y.reshape(B, 1, h * pd)
    y = rms_norm(y.to(x.dtype) * silu(z), m.norm)
    cd = _cd(cfg)
    return y.to(cd) @ m.w_out.to(cd), cache
