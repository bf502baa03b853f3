"""Plain PyTorch reference of a language model's first training steps.

Written from the architectures' descriptions (Mamba-2's SSD block,
arXiv:2405.21060; pre-norm attention with RoPE and q/k RMS norm and a
top-k mixture of experts with capacity-bounded routing, arXiv:2409.02060),
not from the program: it imports nothing of ``repro_torch`` and takes no
tensor the program made.  It is handed the benchmark's weights
(:mod:`bench.inputs`) and token batches, and runs ``len(batches)`` steps of
next-token cross entropy (plus ``aux_coef`` times the experts' load-balance
loss), global-norm clipping, a linear-warmup cosine schedule and AdamW, all
in float32 with TF32 off.

It runs at the timed sizes on the card, so it is computed in blocks: the
batch in blocks of ``rows`` rows whose gradients are summed, each layer
under ``torch.utils.checkpoint``, attention over whole rows, the SSD in the
paper's chunked matrix form (exact; no Python loop over chunks), the
experts by gathering the tokens each admitted.  The load-balance loss takes
its expert fractions over the whole batch, so with experts a first pass
without gradients counts every layer's first choices.

``precision`` rounds the values at the points where a program computing in
that type would hold them (each matrix product's operands and result, each
elementwise result of the convolution, SiLU and gating, the residual
stream, norm, RoPE and attention outputs, the SSD's inputs and output, the
experts' combine weights), forward and backward: ``"float32"`` (no rounding: the reference),
``"bfloat16"``, or ``"float8"`` (e4m3 with a power-of-two scale per
tensor, the step below the configurations' bfloat16: the control).
``half_batch`` trains on the first half of every batch (a fault).

The configuration is the ``arch`` dict of the benchmark's configuration
file (``bench/configs/<name>.json``): its layer kinds ``mamba`` and ``attn``,
feed-forward kinds ``moe``, ``mlp`` and none, at ``tp`` 1, every expert
held and no shared expert.  It refuses a configuration that sets
``moe_experts_held`` or ``moe_shared_d_ff``, whose layers it would compute
only in part; such a configuration brings a reference of its own, which
declares its leaves (``leaf_specs(arch)``, see :mod:`bench.inputs`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["train_steps"]

_FP8_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax().clamp_min(1e-30)
    scale = torch.exp2(torch.floor(torch.log2(_FP8_MAX / amax)))
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


class _Round(torch.autograd.Function):
    """Rounds the value forward and its gradient backward."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def _rounder(precision: str):
    if precision == "float32":
        return lambda t: t
    fn = {"bfloat16": _bf16, "float8": _fp8}[precision]
    return lambda t: _Round.apply(t, fn)


class _Model:
    """The configuration's layers over the weight dict ``w`` (stacked
    leaves indexed by period), with the rounding ``q``."""

    def __init__(self, arch: dict, w: dict, q):
        self.a, self.w, self.q = arch, w, q
        self.n_pos = len(arch["period"])

    def leaf(self, layer: int, key: str) -> torch.Tensor:
        p, i = divmod(layer, self.n_pos)
        return self.w[f"periods/pos{i}/{key}"][p]

    def mm(self, x, w):
        q = self.q
        return q(q(x) @ q(w))

    # -- pieces -----------------------------------------------------------

    def rms(self, x, scale, eps=1e-6):
        return self.q(x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale)

    def silu(self, x):
        return self.q(x * torch.sigmoid(x))

    def rope(self, x):  # (b, s, h, dh); rotate the two halves
        s, dh = x.shape[1], x.shape[-1]
        half = dh // 2
        freqs = torch.exp(-math.log(self.a["rope_theta"]) *
                          torch.arange(half, dtype=torch.float32, device=x.device) / half)
        ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
        cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return self.q(torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1))

    # -- mixers -----------------------------------------------------------

    def attention(self, layer, x):
        a, q = self.a, self.q
        lf = lambda k: self.leaf(layer, f"mixer/{k}")  # noqa: E731
        b, s, _ = x.shape
        qh = q(torch.einsum("bsd,dhk->bshk", q(x), q(lf("wq"))))
        kh = q(torch.einsum("bsd,dhk->bshk", q(x), q(lf("wk"))))
        vh = q(torch.einsum("bsd,dhk->bshk", q(x), q(lf("wv"))))
        if a["qk_norm"]:
            qh, kh = self.rms(qh, lf("q_norm/scale")), self.rms(kh, lf("k_norm/scale"))
        qh, kh = self.rope(qh), self.rope(kh)
        g = qh.shape[2] // kh.shape[2]
        kh, vh = kh.repeat_interleave(g, dim=2), vh.repeat_interleave(g, dim=2)
        scores = torch.einsum("bshk,bthk->bhst", qh, kh) * qh.shape[-1] ** -0.5
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        out = q(torch.einsum("bhst,bthk->bshk", p, vh))
        return q(torch.einsum("bshk,hkd->bsd", out, q(lf("wo"))))

    def conv(self, x, w):  # causal depthwise conv over time, then SiLU
        q = self.q
        k, s = w.shape[0], x.shape[1]
        xp = F.pad(x, (0, 0, k - 1, 0))
        out = q(xp[:, :s] * q(w[0]))
        for j in range(1, k):
            out = q(out + q(xp[:, j:j + s] * q(w[j])))
        return self.silu(out)

    @staticmethod
    def segsum(x):
        """exp-able segment sums: out[..., i, j] = sum(x[..., j+1:i+1]) for
        i >= j, -inf above the diagonal."""
        t = x.shape[-1]
        xx = x[..., None].expand(*x.shape, t)
        below = torch.ones(t, t, dtype=torch.bool, device=x.device).tril(-1)
        xx = xx.masked_fill(~below, 0.0)
        seg = torch.cumsum(xx, dim=-2)
        return seg.masked_fill(~torch.ones(t, t, dtype=torch.bool, device=x.device).tril(),
                               float("-inf"))

    def ssd(self, x, loga, Bm, Cm, chunk):
        """y_t = sum_{s<=t} exp(sum(loga[s+1..t])) (C_t . B_s) x_s, in
        chunks (the paper's minimal SSD).  x (b, t, h, p); loga (b, t, h);
        Bm, Cm (b, t, n)."""
        b, t, h, p = x.shape
        L = min(chunk, t)
        if t % L:
            raise ValueError(f"sequence {t} is not a multiple of the chunk {L}")
        c = t // L
        x = x.reshape(b, c, L, h, p)
        A = loga.reshape(b, c, L, h).permute(0, 3, 1, 2)  # (b, h, c, l)
        Bc, Cc = Bm.reshape(b, c, L, -1), Cm.reshape(b, c, L, -1)
        A_cum = torch.cumsum(A, dim=-1)
        decay = torch.exp(self.segsum(A))  # (b, h, c, l, s)
        G = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
        y_diag = torch.einsum("bcls,bhcls,bcshp->bclhp", G, decay, x)
        to_end = torch.exp(A_cum[..., -1:] - A_cum)  # (b, h, c, l)
        states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, to_end, x)
        states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
        chunk_decay = torch.exp(self.segsum(F.pad(A_cum[..., -1], (1, 0))))  # (b, h, c+1, c+1)
        entering = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
        y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, entering, torch.exp(A_cum))
        return (y_diag + y_off).reshape(b, t, h, p)

    def mamba(self, layer, x):
        a, q = self.a, self.q
        lf = lambda k: self.leaf(layer, f"mixer/{k}")  # noqa: E731
        b, s, _ = x.shape
        ph = a["ssm_head_dim"]
        xi = self.conv(self.mm(x, lf("w_x")), lf("conv_x"))
        z = self.mm(x, lf("w_z"))
        Bm = self.conv(self.mm(x, lf("w_B")), lf("conv_B"))
        Cm = self.conv(self.mm(x, lf("w_C")), lf("conv_C"))
        dtp = F.softplus(self.mm(x, lf("w_dt")) + lf("dt_bias"))
        loga = -torch.exp(lf("A_log")) * dtp
        xh = q(xi.reshape(b, s, -1, ph) * dtp[..., None])
        y = q(q(self.ssd(xh, loga, Bm, Cm, a["ssm_chunk"])) + q(q(lf("D"))[:, None] * xh))
        y = q(y.reshape(b, s, -1) * self.silu(z))
        return self.mm(self.rms(y, lf("norm/scale")), lf("w_out"))

    # -- feed-forward -----------------------------------------------------

    def mlp(self, layer, x):
        lf = lambda k: self.leaf(layer, f"ffn/{k}")  # noqa: E731
        return self.mm(self.q(self.silu(self.mm(x, lf("w1"))) * self.mm(x, lf("w3"))), lf("w2"))

    def route(self, layer, x, n_tokens):
        """Top-k routing in groups of ``moe_group_size`` tokens: (probs (T,
        E), expert ids (T, k), weights (T, k), admitted (T, k)).  An expert
        admits at most its capacity of a group's tokens: all first choices
        before any second, each choice in token order."""
        a = self.a
        e, k = a["moe_experts"], a["moe_top_k"]
        d = x.shape[-1]
        gs = min(a["moe_group_size"], n_tokens)
        xt = x.reshape(-1, gs, d)
        probs = torch.softmax(xt @ self.leaf(layer, "ffn/router"), dim=-1)  # (G, gs, E)
        w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        w, idx = w[..., :k], idx[..., :k]
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        cap = max(1, int(gs * k * a["moe_capacity_factor"] / e))
        cap = -(-cap // 4) * 4
        counts = torch.zeros(xt.shape[0], 1, e, device=x.device)
        admitted = []
        for j in range(k):
            oh = F.one_hot(idx[..., j], e).float()
            ahead = counts + torch.cumsum(oh, dim=1) - oh  # tokens before this one
            admitted.append(torch.gather(ahead, 2, idx[..., j:j + 1])[..., 0] < cap)
            counts = counts + oh.sum(dim=1, keepdim=True)
        return (probs.reshape(-1, e), idx.reshape(-1, k), w.reshape(-1, k),
                torch.stack(admitted, -1).reshape(-1, k))

    def moe(self, layer, x, n_tokens, first_frac):
        """(output, this block's part of the load-balance loss, its tokens'
        first-choice counts per expert); the loss takes the whole batch's
        first-choice fractions ``first_frac`` (E,), none in the counting
        pass."""
        a = self.a
        e = a["moe_experts"]
        b, s, d = x.shape
        probs, idx, w, adm = self.route(layer, x, n_tokens)
        xt = x.reshape(-1, d)
        out = torch.zeros_like(xt)
        w1, w3, w2 = (self.leaf(layer, f"ffn/{k}") for k in ("w1", "w3", "w2"))
        for ex in range(e):
            tok, j = torch.nonzero((idx == ex) & adm, as_tuple=True)
            if tok.numel() == 0:
                continue
            xe = xt[tok]
            he = self.q(self.silu(self.mm(xe, w1[ex])) * self.mm(xe, w3[ex]))
            out = out.index_add(0, tok, self.q(self.mm(he, w2[ex]) * self.q(w[tok, j])[:, None]))
        aux = x.new_zeros(()) if first_frac is None else \
            e * torch.sum(first_frac * probs.sum(0)) / n_tokens
        return self.q(out).reshape(b, s, d), aux, F.one_hot(idx[:, 0], e).float().sum(0)

    # -- the model --------------------------------------------------------

    def ffn_kind(self, layer):
        i = layer % self.n_pos
        if i in self.a["moe_positions"]:
            return "moe"
        if self.a["period"][i] == "mamba" and self.a["family"] == "ssm":
            return "none"
        return "mlp"

    def block(self, layer, x, n_tokens, first_frac, counts=None):
        """One layer: (output, its load-balance loss).  ``counts``: a dict
        that gathers each MoE layer's first-choice counts."""
        kind = self.a["period"][layer % self.n_pos]
        h = self.rms(x, self.leaf(layer, "norm1/scale"))
        x = self.q(x + (self.mamba(layer, h) if kind == "mamba" else self.attention(layer, h)))
        aux = x.new_zeros(())
        fk = self.ffn_kind(layer)
        if fk != "none":
            h2 = self.rms(x, self.leaf(layer, "norm2/scale"))
            if fk == "moe":
                y, aux, first = self.moe(layer, h2, n_tokens, first_frac.get(layer))
                if counts is not None:
                    counts[layer] = counts.get(layer, 0) + first
            else:
                y = self.mlp(layer, h2)
            x = self.q(x + y)
        return x, aux

    def embed(self, tokens):
        return self.q(self.w["embed/table"][tokens])

    def block_loss(self, tokens, n_tokens, n_targets, first_frac):
        """This block of rows' share of the loss: its summed cross entropy
        over ``n_targets`` plus ``aux_coef`` times its share of the
        load-balance loss."""
        x = self.embed(tokens)
        aux = x.new_zeros(())
        for layer in range(self.a["n_layers"]):
            x, a_l = checkpoint(self.block, layer, x, n_tokens, first_frac, use_reentrant=False)
            aux = aux + a_l
        h = self.rms(x, self.w["final_norm/scale"])
        logits = self.mm(h, self.w["embed/head"][:, :self.a["vocab"]])
        ce = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                             tokens[:, 1:].reshape(-1).long(), reduction="sum")
        return ce / n_targets, aux

    @torch.no_grad()
    def first_fractions(self, batch, rows):
        """Each MoE layer's fraction of the batch's tokens whose first
        choice is each expert (a pass without gradients), by layer."""
        counts: dict = {}
        for r in range(0, batch.shape[0], rows):
            x = self.embed(batch[r:r + rows])
            for layer in range(self.a["n_layers"]):
                x, _ = self.block(layer, x, batch.numel(), {}, counts)
        return {layer: c / batch.numel() for layer, c in counts.items()}


def _cosine_warmup(step: int, *, peak_lr, warmup, total_steps, floor_frac=0.1, **_):
    t = float(step)
    if t < warmup:
        return peak_lr * (t + 1.0) / max(warmup, 1)
    prog = min(max((t - warmup) / max(total_steps - warmup, 1), 0.0), 1.0)
    return peak_lr * (floor_frac + (1 - floor_frac) * 0.5 * (1 + math.cos(math.pi * prog)))


def _norms(t: torch.Tensor) -> torch.Tensor:
    """The norm of each period's part of a stacked leaf."""
    return torch.linalg.vector_norm(t.reshape(t.shape[0], -1), dim=1)


def train_steps(arch: dict, hparams: dict, adamw: dict, w: dict, batches: list,
                *, precision: str = "float32", half_batch: bool = False,
                rows: int = 1) -> dict:
    """Run ``len(batches)`` training steps from the weights ``w`` (a dict of
    float32 leaves, updated in place).  Returns, per step, the loss and the
    gradients' global norm before clipping; per part of each leaf (a
    period's slice of a stacked leaf, the leaf itself otherwise) the norm
    of the first step's gradient before (``raw_grad``) and after
    (``first_grad``) clipping and of the parameters' change over all the
    steps."""
    share = [k for k in ("moe_experts_held", "moe_shared_d_ff") if arch.get(k, 0)]
    if share:
        raise ValueError(f"{arch['name']}: the plain lm reference implements no expert share and "
                         f"no shared expert, so it cannot follow {share}; name a reference of "
                         f"the configuration's own")
    q = _rounder(precision)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        params = {k: v.detach().requires_grad_(True) for k, v in w.items()}
        start = {k: v.detach().clone() for k, v in params.items()}
        model = _Model(arch, params, q)
        mu = {k: torch.zeros_like(v) for k, v in params.items()}
        nu = {k: torch.zeros_like(v) for k, v in params.items()}
        b1, b2, eps, wd = adamw["b1"], adamw["b2"], adamw["eps"], adamw["weight_decay"]
        aux_coef = hparams["aux_coef"]
        out = {"loss": [], "grad_norm": []}
        for step, batch in enumerate(batches):
            batch = torch.as_tensor(batch, device=next(iter(params.values())).device)
            if half_batch:
                batch = batch[: batch.shape[0] // 2]
            n_tokens = batch.numel()
            n_targets = batch.shape[0] * (batch.shape[1] - 1)
            fracs = model.first_fractions(batch, rows) if any(
                model.ffn_kind(layer) == "moe" for layer in range(arch["n_layers"])) else {}
            loss = 0.0
            for r in range(0, batch.shape[0], rows):
                ce, aux = model.block_loss(batch[r:r + rows], n_tokens, n_targets, fracs)
                part = ce + aux_coef * aux
                part.backward()
                loss += float(part.detach())
            grads = {k: v.grad.detach() for k, v in params.items()}
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            scale = torch.clamp(hparams["clip_norm"] / (gnorm + 1e-9), max=1.0)
            if step == 0:
                out["raw_grad"] = {k: _stacked_norms(k, g, arch) for k, g in grads.items()}
            grads = {k: g * scale for k, g in grads.items()}
            if step == 0:
                out["first_grad"] = {k: _stacked_norms(k, g, arch) for k, g in grads.items()}
            lr = _cosine_warmup(step, **hparams)
            t = step + 1
            c1, c2 = 1 - b1 ** t, 1 - b2 ** t
            with torch.no_grad():
                for k, p in params.items():
                    g = grads[k]
                    mu[k].mul_(b1).add_((1 - b1) * g)
                    nu[k].mul_(b2).add_((1 - b2) * g * g)
                    adam = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
                    p.sub_(lr * (adam + wd * p))
                    p.grad = None
            out["loss"].append(loss)
            out["grad_norm"].append(float(gnorm))
        out["update"] = {k: _stacked_norms(k, params[k].detach() - start[k], arch)
                         for k in params}
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _stacked_norms(key: str, t: torch.Tensor, arch: dict) -> list[float]:
    """Per-part norms of leaf ``key``: per period for a stacked leaf."""
    if key.startswith("periods/"):
        return _norms(t).tolist()
    return [float(torch.linalg.vector_norm(t))]
