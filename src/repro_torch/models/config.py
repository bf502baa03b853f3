"""Architecture configuration for the model zoo (the port's copy of
``repro/models/config.py``; pure Python, the same fields and derived
properties, and a few of the port's own: a card's share of an
expert-parallel layer and a shared expert, a conv bias, NoPE attention, the
muP multipliers and a tied head, each at a default that changes nothing).

One frozen dataclass describes every assigned architecture (dense / MoE /
SSM / hybrid / enc-dec / VLM).  Layer stacks are expressed as repeating
*periods* (a short list of layer kinds) so that ``jax.lax.scan`` can run over
stacked period parameters — keeping compiled HLO size proportional to one
period rather than the full depth, which matters for 95-layer models on a
512-device dry-run.

TPU-shardability adjustments (documented in DESIGN.md and counted honestly
in the roofline's MODEL_FLOPS / HLO_FLOPS ratio):

* ``padded_q_heads`` — query heads padded up to a multiple of the tensor-
  parallel axis (llama4-scout 40->48, phi4 24->32); padded heads have zero
  weights and zero output contribution.
* ``stored_kv_heads`` — KV heads replicated up to the TP degree when
  ``kv < tp`` (MaxText-style), so the KV cache shards exactly.
* ``padded_vocab`` — vocab padded to a multiple of ``tp * 128`` for lane
  alignment and exact vocab-parallel sharding; padded logits are masked.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

__all__ = ["ArchConfig", "LayerKind", "TP_DEGREE"]

# The production mesh's model-parallel degree (launch/mesh.py).
TP_DEGREE = 16

LayerKind = Literal["attn", "mamba", "cross"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qk_norm: bool = False
    rope_theta: float = 500_000.0
    # --- layer pattern: one period, repeated n_layers/len(period) times ----
    # kinds: "attn" (self-attention), "mamba" (SSD block), "cross"
    # (self-attention + cross-attention, for VLM/enc-dec periods)
    period: tuple[str, ...] = ("attn",)
    # which positions within the period use MoE instead of a dense FFN
    moe_positions: tuple[int, ...] = ()
    # --- MoE ---------------------------------------------------------------
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0  # expert hidden width (defaults to d_ff)
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 256  # routing group (tokens) for dispatch einsums
    # a card's share of an expert-parallel layer: the experts it holds of the
    # router's ``moe_experts`` (0: every one), and a shared expert's width
    # (a SwiGLU every token passes; 0: none).  Port-only fields.
    moe_experts_held: int = 0
    moe_shared_d_ff: int = 0
    # --- SSM (mamba2) --------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    ssm_conv_bias: bool = False  # a bias on each of the x, B and C filters
    # --- attention and muP multipliers (port-only; the defaults change nothing)
    nope: bool = False  # no position embedding (no RoPE) in self-attention
    attention_multiplier: float = 0.0  # the score scale; 0: head_dim ** -0.5
    embedding_multiplier: float = 1.0  # on the embedding's output
    residual_multiplier: float = 1.0  # on each mixer and FFN branch before the residual add
    logits_scaling: float = 1.0  # the logits are divided by it
    tie_embeddings: bool = False  # the output head is the token table's transpose
    # --- encoder-decoder ----------------------------------------------------
    enc_layers: int = 0  # encoder depth (decoder depth = n_layers)
    # --- multimodal stub frontend -------------------------------------------
    n_context_tokens: int = 0  # precomputed patch/frame embeddings (B, n, d)
    # --- serving ------------------------------------------------------------
    kv_block: int = 256  # facet (block) size of the KV cache sequence axis
    kv_cache_dtype: str = "bfloat16"  # fp8 halves the decode memory term (§Perf H2)
    # --- numerics -----------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"  # adamw | adafactor (jamba-scale memory relief)
    tp: int = TP_DEGREE
    # --- parallelism policy (§Perf H4) ---------------------------------------
    # "tp": Megatron TP/EP over 'model' + DP/FSDP over 'pod','data'
    # "dp": pure data parallelism — 'model' folds into the batch axes;
    #       right for small-d_model archs where 16-way TP shards are tiny
    #       and the per-layer all-reduces dominate the roofline
    parallelism: str = "tp"

    # ------------------------------------------------------------------ derived

    def __post_init__(self):
        if self.n_layers % len(self.period):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} must divide by "
                f"period length {len(self.period)}"
            )
        for p in self.moe_positions:
            if not (0 <= p < len(self.period)):
                raise ValueError(f"{self.name}: moe position {p} out of period")
        if not 0 <= self.moe_experts_held <= self.moe_experts:
            raise ValueError(f"{self.name}: moe_experts_held {self.moe_experts_held} of "
                             f"{self.moe_experts} experts")

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.period)

    @property
    def padded_q_heads(self) -> int:
        return _round_up(self.n_heads, self.tp)

    @property
    def stored_kv_heads(self) -> int:
        if self.n_kv_heads >= self.tp:
            if self.n_kv_heads % self.tp:
                raise ValueError(f"{self.name}: kv heads {self.n_kv_heads} vs tp")
            return self.n_kv_heads
        if self.tp % self.n_kv_heads:
            raise ValueError(f"{self.name}: kv heads {self.n_kv_heads} vs tp")
        return self.tp

    @property
    def q_per_kv(self) -> int:
        return self.padded_q_heads // self.stored_kv_heads

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab, self.tp * 128)

    # SSM deriveds
    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        assert self.ssm_d_inner % self.ssm_head_dim == 0
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def experts_held(self) -> int:
        """The experts a MoE layer holds (all of them unless a share)."""
        return self.moe_experts_held or self.moe_experts

    @property
    def score_scale(self) -> float:
        """Attention's score scale."""
        return self.attention_multiplier or self.head_dim ** -0.5

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def has_ssm(self) -> bool:
        return "mamba" in self.period

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing (SSM/hybrid) — long_500k eligibility."""
        return self.has_ssm

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs generate tokens (enc-dec included)

    def param_count(self) -> int:
        """Analytic parameter count (unpadded, for 6ND MODEL_FLOPS): a tied
        table once, the held experts of a share, a shared expert."""
        d, v = self.d_model, self.vocab
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d  # unembed
        per_period = 0
        for i, kind in enumerate(self.period):
            if kind in ("attn", "cross"):
                per_period += d * self.n_heads * self.head_dim * 2  # wq, wo
                per_period += d * self.n_kv_heads * self.head_dim * 2  # wk, wv
                if kind == "cross":
                    per_period += d * self.n_heads * self.head_dim * 2
                    per_period += d * self.n_kv_heads * self.head_dim * 2
            elif kind == "mamba":
                din, n, h = self.ssm_d_inner, self.ssm_state, self.ssm_heads
                per_period += d * din * 2  # w_x, w_z
                per_period += d * n * 2 + d * h  # w_B, w_C, w_dt
                per_period += din * d  # out_proj
            if i in self.moe_positions:
                per_period += self.experts_held * 3 * d * self.expert_d_ff
                per_period += d * self.moe_experts  # router
                per_period += 3 * d * self.moe_shared_d_ff
            elif kind != "mamba":
                per_period += 3 * d * self.d_ff
        total += self.n_periods * per_period
        if self.is_encdec:  # encoder layers: self-attn + dense FFN
            total += self.enc_layers * (
                d * self.n_heads * self.head_dim * 2
                + d * self.n_kv_heads * self.head_dim * 2
                + 3 * d * self.d_ff
            )
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k experts only; of a share,
        the ``moe_top_k × held / moe_experts`` experts a token meets on this
        card under uniform routing, a fraction where that is not whole)."""
        if not self.moe_experts:
            return self.param_count()
        full = self.param_count()
        n_moe = self.n_periods * len(self.moe_positions)
        expert = 3 * self.d_model * self.expert_d_ff
        all_experts = n_moe * self.experts_held * expert
        met, rest = divmod(self.moe_top_k * self.experts_held * expert, self.moe_experts)
        active = n_moe * (self.moe_top_k * self.experts_held * expert / self.moe_experts
                          if rest else met)
        return full - all_experts + active
