"""Plain PyTorch reference of granite-4.0-h-small's first training steps, as
one card of an expert-parallel deployment holds the model.

Written from the model's description (IBM's Granite 4.0-H ``config.json``
and the GraniteMoeHybrid architecture: a period of Mamba-2 and attention
layers, each with a mixture of experts and a shared expert, and muP
multipliers), not from the program: it imports nothing of ``repro_torch``
and takes no tensor the program made.  It reuses the plain ``lm``
reference's pieces (``bench/reference/lm.py``: rounding, norms, the SSD in
the paper's chunked matrix form, top-k routing with capacity, the step's
schedule and AdamW) and changes what this model does otherwise:

* attention without a position embedding (NoPE), its scores scaled by
  ``attention_multiplier`` (1/128, not 1/sqrt(128));
* a bias on each depthwise filter (x, B and C), added before the SiLU;
* the embedding's output times ``embedding_multiplier``, each mixer's and
  feed-forward's output times ``residual_multiplier`` before its residual
  add, and the logits the final norm's output times the token table's
  transpose (the head is tied to the table), divided by ``logits_scaling``;
* every layer's mixture of experts routes each token over all
  ``moe_experts`` (the full softmax, top-k, renormalised, the capacity of
  the whole layer), computes the part of the output of the experts this
  card holds (``moe_experts_held`` of them from ``first_expert``, 0 by
  default: rank 0 of the group) and leaves out the other experts' part,
  which other cards would add; a shared expert (a SwiGLU of width
  ``moe_shared_d_ff``) adds its output for every token; the load-balance
  loss is over all the experts.

All in float32 with TF32 off, in blocks of ``rows`` rows, each layer under
``torch.utils.checkpoint``.  ``precision`` and ``half_batch`` are the plain
``lm`` reference's (the control and a fault), so ``bench.limits`` takes
them unchanged.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench import registry
from bench.inputs import padded_vocab

__all__ = ["leaf_specs", "train_steps"]

_lm = registry.reference("lm")


def leaf_specs(arch: dict) -> list[tuple[str, tuple, str, float]]:
    """(key, shape, init, scale) of every leaf, sorted by key: the program's
    parameter leaves (layers stacked by period), with the router over all
    experts and the held experts' weights, a shared expert, the conv biases
    (zeros) and no ``embed/head``: the head is the table, which therefore
    takes the head's N(0, d^-1/2) of the plain ``lm`` reference (at N(0, 1)
    the embedding multiplier would make each token's own logit ≈ 256 and
    the first loss ≈ 255, the next token's part of it lost in the rest)."""
    if arch["tp"] != 1:
        raise ValueError("the benchmark runs its configurations at tp=1 (no padded heads)")
    d, vp = arch["d_model"], padded_vocab(arch)
    n_per = arch["n_layers"] // len(arch["period"])
    e, held = arch["moe_experts"], arch["moe_experts_held"] or arch["moe_experts"]
    f, fs = arch["moe_d_ff"] or arch["d_ff"], arch["moe_shared_d_ff"]
    specs = [("embed/table", (vp, d), "normal", d ** -0.5),
             ("final_norm/scale", (d,), "ones", 0.0)]
    for i, kind in enumerate(arch["period"]):
        leaves = [("norm1/scale", (d,), "ones", 0.0), ("norm2/scale", (d,), "ones", 0.0)]
        if kind == "mamba":
            din = arch["ssm_expand"] * d
            n, k = arch["ssm_state"], arch["ssm_conv"]
            h = din // arch["ssm_head_dim"]
            leaves += [("mixer/w_x", (d, din), "normal", d ** -0.5),
                       ("mixer/w_z", (d, din), "normal", d ** -0.5),
                       ("mixer/w_B", (d, n), "normal", d ** -0.5),
                       ("mixer/w_C", (d, n), "normal", d ** -0.5),
                       ("mixer/w_dt", (d, h), "normal", d ** -0.5),
                       ("mixer/conv_x", (k, din), "normal", k ** -0.5),
                       ("mixer/conv_B", (k, n), "normal", k ** -0.5),
                       ("mixer/conv_C", (k, n), "normal", k ** -0.5),
                       ("mixer/conv_x_bias", (din,), "zeros", 0.0),
                       ("mixer/conv_B_bias", (n,), "zeros", 0.0),
                       ("mixer/conv_C_bias", (n,), "zeros", 0.0),
                       ("mixer/w_out", (din, d), "normal", din ** -0.5),
                       ("mixer/dt_bias", (h,), "dt_bias", 0.0),
                       ("mixer/A_log", (h,), "a_log", 0.0),
                       ("mixer/D", (h,), "ones", 0.0),
                       ("mixer/norm/scale", (din,), "ones", 0.0)]
        elif kind == "attn":
            hq, hkv, dh = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
            leaves += [("mixer/wq", (d, hq, dh), "normal", d ** -0.5),
                       ("mixer/wk", (d, hkv, dh), "normal", d ** -0.5),
                       ("mixer/wv", (d, hkv, dh), "normal", d ** -0.5),
                       ("mixer/wo", (hq, dh, d), "normal", (hq * dh) ** -0.5)]
        else:
            raise ValueError(f"layer kind {kind!r} has no reference here")
        if i not in arch["moe_positions"]:
            raise ValueError(f"position {i} has no mixture of experts: every layer has one")
        leaves += [("ffn/router", (d, e), "normal", d ** -0.5),
                   ("ffn/w1", (held, d, f), "normal", d ** -0.5),
                   ("ffn/w3", (held, d, f), "normal", d ** -0.5),
                   ("ffn/w2", (held, f, d), "normal", f ** -0.5)]
        if fs:
            leaves += [("ffn/shared/w1", (d, fs), "normal", d ** -0.5),
                       ("ffn/shared/w3", (d, fs), "normal", d ** -0.5),
                       ("ffn/shared/w2", (fs, d), "normal", fs ** -0.5)]
        specs += [(f"periods/pos{i}/{key}", (n_per, *shape), init, scale)
                  for key, shape, init, scale in leaves]
    return sorted(specs)


class Model(_lm._Model):
    """The configuration's layers over the weight dict ``w``, with the
    rounding ``q``; a MoE layer holds the experts from ``first_expert``."""

    def __init__(self, arch: dict, w: dict, q, first_expert: int = 0):
        super().__init__(arch, w, q)
        self.first_expert = first_expert

    def branch(self, y):
        """A branch's output as the residual stream takes it."""
        return self.q(y * self.a["residual_multiplier"])

    def attention(self, layer, x):
        a, q = self.a, self.q
        lf = lambda k: self.leaf(layer, f"mixer/{k}")  # noqa: E731
        s = x.shape[1]
        qh = q(torch.einsum("bsd,dhk->bshk", q(x), q(lf("wq"))))
        kh = q(torch.einsum("bsd,dhk->bshk", q(x), q(lf("wk"))))
        vh = q(torch.einsum("bsd,dhk->bshk", q(x), q(lf("wv"))))
        if not a["nope"]:
            qh, kh = self.rope(qh), self.rope(kh)
        g = qh.shape[2] // kh.shape[2]
        kh, vh = kh.repeat_interleave(g, dim=2), vh.repeat_interleave(g, dim=2)
        scale = a["attention_multiplier"] or qh.shape[-1] ** -0.5
        scores = torch.einsum("bshk,bthk->bhst", qh, kh) * scale
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        out = q(torch.einsum("bhst,bthk->bshk", p, vh))
        return q(torch.einsum("bshk,hkd->bsd", out, q(lf("wo"))))

    def conv_bias(self, x, w, bias):
        """The causal depthwise conv over time plus its bias, then SiLU."""
        q = self.q
        k, s = w.shape[0], x.shape[1]
        xp = F.pad(x, (0, 0, k - 1, 0))
        out = q(xp[:, :s] * q(w[0]))
        for j in range(1, k):
            out = q(out + q(xp[:, j:j + s] * q(w[j])))
        return self.silu(q(out + q(bias)))

    def mamba(self, layer, x):
        a, q = self.a, self.q
        lf = lambda k: self.leaf(layer, f"mixer/{k}")  # noqa: E731
        b, s, _ = x.shape
        ph = a["ssm_head_dim"]
        xi = self.conv_bias(self.mm(x, lf("w_x")), lf("conv_x"), lf("conv_x_bias"))
        z = self.mm(x, lf("w_z"))
        Bm = self.conv_bias(self.mm(x, lf("w_B")), lf("conv_B"), lf("conv_B_bias"))
        Cm = self.conv_bias(self.mm(x, lf("w_C")), lf("conv_C"), lf("conv_C_bias"))
        dtp = F.softplus(self.mm(x, lf("w_dt")) + lf("dt_bias"))
        loga = -torch.exp(lf("A_log")) * dtp
        xh = q(xi.reshape(b, s, -1, ph) * dtp[..., None])
        y = q(q(self.ssd(xh, loga, Bm, Cm, a["ssm_chunk"])) + q(q(lf("D"))[:, None] * xh))
        y = q(y.reshape(b, s, -1) * self.silu(z))
        return self.mm(self.rms(y, lf("norm/scale")), lf("w_out"))

    def moe(self, layer, x, n_tokens, first_frac):
        """(output, this block's part of the load-balance loss, its tokens'
        first-choice counts per expert): the held experts' part of the
        routed output plus the shared expert's."""
        a, q = self.a, self.q
        e = a["moe_experts"]
        held = a["moe_experts_held"] or e
        b, s, d = x.shape
        probs, idx, w, adm = self.route(layer, x, n_tokens)
        xt = x.reshape(-1, d)
        out = torch.zeros_like(xt)
        w1, w3, w2 = (self.leaf(layer, f"ffn/{k}") for k in ("w1", "w3", "w2"))
        for i in range(held):
            tok, j = torch.nonzero((idx == self.first_expert + i) & adm, as_tuple=True)
            if tok.numel() == 0:
                continue
            xe = xt[tok]
            he = q(self.silu(self.mm(xe, w1[i])) * self.mm(xe, w3[i]))
            out = out.index_add(0, tok, q(self.mm(he, w2[i]) * q(w[tok, j])[:, None]))
        out = q(out).reshape(b, s, d)
        if a["moe_shared_d_ff"]:
            sf = lambda k: self.leaf(layer, f"ffn/shared/{k}")  # noqa: E731
            out = q(out + self.mm(q(self.silu(self.mm(x, sf("w1"))) * self.mm(x, sf("w3"))),
                                  sf("w2")))
        aux = x.new_zeros(()) if first_frac is None else \
            e * torch.sum(first_frac * probs.sum(0)) / n_tokens
        return out, aux, F.one_hot(idx[:, 0], e).float().sum(0)

    def block(self, layer, x, n_tokens, first_frac, counts=None):
        """One layer: (output, its load-balance loss).  ``counts``: a dict
        that gathers each layer's first-choice counts."""
        kind = self.a["period"][layer % self.n_pos]
        h = self.rms(x, self.leaf(layer, "norm1/scale"))
        y = self.mamba(layer, h) if kind == "mamba" else self.attention(layer, h)
        x = self.q(x + self.branch(y))
        h2 = self.rms(x, self.leaf(layer, "norm2/scale"))
        y, aux, first = self.moe(layer, h2, n_tokens, first_frac.get(layer))
        if counts is not None:
            counts[layer] = counts.get(layer, 0) + first
        return self.q(x + self.branch(y)), aux

    def embed(self, tokens):
        return self.q(self.w["embed/table"][tokens] * self.a["embedding_multiplier"])

    def logits(self, h):
        """The tied head: the token table's transpose, the logits divided by
        ``logits_scaling``."""
        return self.q(self.mm(h, self.w["embed/table"][:self.a["vocab"]].t())
                      / self.a["logits_scaling"])

    def block_loss(self, tokens, n_tokens, n_targets, first_frac):
        x = self.embed(tokens)
        aux = x.new_zeros(())
        for layer in range(self.a["n_layers"]):
            x, a_l = checkpoint(self.block, layer, x, n_tokens, first_frac,
                                use_reentrant=False)
            aux = aux + a_l
        logits = self.logits(self.rms(x, self.w["final_norm/scale"]))
        ce = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                             tokens[:, 1:].reshape(-1).long(), reduction="sum")
        return ce / n_targets, aux


def train_steps(arch: dict, hparams: dict, adamw: dict, w: dict, batches: list,
                *, precision: str = "float32", half_batch: bool = False,
                rows: int = 1) -> dict:
    """Run ``len(batches)`` training steps from the weights ``w`` (a dict of
    float32 leaves, updated in place), as the plain ``lm`` reference's
    ``train_steps`` does, and return the same readings."""
    q = _lm._rounder(precision)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        params = {k: v.detach().requires_grad_(True) for k, v in w.items()}
        start = {k: v.detach().clone() for k, v in params.items()}
        model = Model(arch, params, q)
        mu = {k: torch.zeros_like(v) for k, v in params.items()}
        nu = {k: torch.zeros_like(v) for k, v in params.items()}
        b1, b2, eps, wd = adamw["b1"], adamw["b2"], adamw["eps"], adamw["weight_decay"]
        out = {"loss": [], "grad_norm": []}
        for step, batch in enumerate(batches):
            batch = torch.as_tensor(batch, device=next(iter(params.values())).device)
            if half_batch:
                batch = batch[: batch.shape[0] // 2]
            n_tokens = batch.numel()
            n_targets = batch.shape[0] * (batch.shape[1] - 1)
            fracs = model.first_fractions(batch, rows)
            loss = 0.0
            for r in range(0, batch.shape[0], rows):
                ce, aux = model.block_loss(batch[r:r + rows], n_tokens, n_targets, fracs)
                part = ce + hparams["aux_coef"] * aux
                part.backward()
                loss += float(part.detach())
            grads = {k: v.grad.detach() for k, v in params.items()}
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            scale = torch.clamp(hparams["clip_norm"] / (gnorm + 1e-9), max=1.0)
            if step == 0:
                out["raw_grad"] = {k: _lm._stacked_norms(k, g, arch) for k, g in grads.items()}
            grads = {k: g * scale for k, g in grads.items()}
            if step == 0:
                out["first_grad"] = {k: _lm._stacked_norms(k, g, arch) for k, g in grads.items()}
            lr = _lm._cosine_warmup(step, **hparams)
            t = step + 1
            c1, c2 = 1 - b1 ** t, 1 - b2 ** t
            with torch.no_grad():
                for k, p in params.items():
                    g = grads[k]
                    mu[k].mul_(b1).add_((1 - b1) * g)
                    nu[k].mul_(b2).add_((1 - b2) * g * g)
                    p.sub_(lr * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps) + wd * p))
                    p.grad = None
            out["loss"].append(loss)
            out["grad_norm"].append(float(gnorm))
        out["update"] = {k: _lm._stacked_norms(k, params[k].detach() - start[k], arch)
                         for k in params}
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
