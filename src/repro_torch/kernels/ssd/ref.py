"""Plain PyTorch versions of the Mamba2 SSD (state-space duality) scan.

:func:`ssd_scan_ref` is the port of ``repro/kernels/ssd/ref.py``: the
sequential recurrence, per head h with state S in R^{P x N},

    S_t = a_t * S_{t-1} + x_t (outer) B_t
    y_t = S_t C_t

with ``a_t = exp(loga_t)``.  :func:`ssd_chunked_ref` is the plain version of
the chunked kernel: the same chunk math as the reference model's
``_ssd_chunked`` (``repro/models/mamba2.py``) and the Pallas kernel body —
per chunk an intra-chunk masked-decay product and an inter-chunk term read
from the carried state, the chunk's flow-out facet.  The ``ssd_scan``
wrapper runs it for tensors on the CPU.  :func:`ssd_chunked_bwd_ref`, the
plain version of the backward kernel, is autograd through it.
"""
from __future__ import annotations

import torch

__all__ = ["ssd_scan_ref", "ssd_chunked_ref", "ssd_chunked_bwd_ref"]


def ssd_scan_ref(
    x: torch.Tensor,  # (B, T, H, P)
    loga: torch.Tensor,  # (B, T, H) — log decay, <= 0
    Bmat: torch.Tensor,  # (B, T, N) — input projection (ngroups = 1)
    C: torch.Tensor,  # (B, T, N) — output projection
    init_state: torch.Tensor | None = None,  # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:  # y (B, T, H, P), final state (B, H, P, N)
    Bb, T, H, P = x.shape
    N = Bmat.shape[-1]
    xf, lf, Bf, Cf = x.float(), loga.float(), Bmat.float(), C.float()
    S = (torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(T):
        a_t = torch.exp(lf[:, t])[:, :, None, None]  # (B,H,1,1)
        S = a_t * S + xf[:, t][..., None] * Bf[:, t][:, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", S, Cf[:, t]))
    y = torch.stack(ys, 1).to(x.dtype)  # (B, T, H, P)
    return y, S


def ssd_chunked_ref(
    x: torch.Tensor,  # (B, T, H, P)
    loga: torch.Tensor,  # (B, T, H) f32
    Bm: torch.Tensor,  # (B, T, N)
    C: torch.Tensor,  # (B, T, N)
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan in chunks of ``chunk`` steps (``T % chunk == 0``);
    returns y in ``x.dtype`` and the final state in float32."""
    Bb, T, H, Pd = x.shape
    N = Bm.shape[-1]
    if T % chunk:
        raise ValueError(f"T={T} must divide by chunk={chunk}")
    L, nc = chunk, T // chunk
    xc = x.float().reshape(Bb, nc, L, H, Pd)
    lc = loga.float().reshape(Bb, nc, L, H)
    Bc = Bm.float().reshape(Bb, nc, L, N)
    Cc = C.float().reshape(Bb, nc, L, N)
    idx = torch.arange(L, device=x.device)
    mask = idx[:, None] >= idx[None, :]

    S = torch.zeros((Bb, H, Pd, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xk, lk, Bk, Ck = xc[:, c], lc[:, c], Bc[:, c], Cc[:, c]
        lcum = torch.cumsum(lk, dim=1)  # (B,L,H)
        ltot = lcum[:, -1]  # (B,H)
        # inter-chunk: read the incoming facet
        cs = torch.einsum("bln,bhpn->blhp", Ck, S)
        y_inter = torch.exp(lcum)[..., None] * cs
        # intra-chunk: masked decay attention
        G = torch.einsum("bln,bsn->bls", Ck, Bk)  # (B, L_t, L_s)
        ldiff = lcum[:, :, None, :] - lcum[:, None, :, :]  # (B, Lt, Ls, H)
        W = torch.where(mask[None, :, :, None], torch.exp(ldiff) * G[..., None], 0.0)
        y_intra = torch.einsum("blsh,bshp->blhp", W, xk)
        # flow-out facet: next chunk's state
        wout = torch.exp(ltot[:, None] - lcum)  # (B,L,H)
        dS = torch.einsum("blhp,bln->bhpn", xk * wout[..., None], Bk)
        S = torch.exp(ltot)[..., None, None] * S + dS
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, 1).reshape(Bb, T, H, Pd)
    return y.to(x.dtype), S


def ssd_chunked_bwd_ref(
    x: torch.Tensor,
    loga: torch.Tensor,
    Bm: torch.Tensor,
    C: torch.Tensor,
    dy: torch.Tensor,  # (B, T, H, P): the gradient of y
    dstate: torch.Tensor | None,  # (B, H, P, N): the final state's gradient (None: zero)
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`ssd_chunked_ref` by autograd: (dx, dloga, dB,
    dC) in the inputs' dtypes."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (x, loga, Bm, C)]
        y, S = ssd_chunked_ref(*inputs, chunk)
        outs, grads = [y], [dy.to(y.dtype)]
        if dstate is not None:
            outs.append(S)
            grads.append(dstate.to(S.dtype))
        return tuple(torch.autograd.grad(outs, inputs, grads))
