"""granite-4.0-h-small [hybrid]: 40L d_model=4096, 36 Mamba-2 layers (128
heads x 64, state 128, one group, conv 4 with a bias) and 4 GQA attention
layers (32 q / 8 kv heads x 128, no position embedding), a period of 10
(attention at position 5); every layer a MoE of 72 experts of width 768,
top-10, plus a shared expert of width 1536; muP multipliers (embedding 12,
attention scores 1/128, residual 0.22, logits / 16), tied embeddings,
vocab=100352.  [ibm-granite/granite-4.0-h-small config.json; 32B-A9B]

Departures from the released model (the port's, each listed where the
benchmark runs it):

* SSD chunk 128 (``mamba_chunk_size`` 256): ``ssd_scan`` takes chunks of
  at most 128; the chunked SSD is exact at any chunk.
* RMSNorm eps 1e-6 (``rms_norm_eps`` 1e-5): the port's norms have one eps.
* capacity-bounded routing, factor 1.25 in groups of 256 tokens, past which
  an expert drops a token (the residual carries it); Granite trains
  dropless.
* the port's Switch load-balance loss (``aux_coef``) in place of Granite's
  router auxiliary loss.
* three depthwise filters with three biases (x, B and C) in place of one
  filter and bias over their concatenation: the same arithmetic per
  channel, so exact.
"""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=768,
    vocab=100352,
    head_dim=128,
    rope_theta=10_000.0,
    period=("mamba",) * 5 + ("attn",) + ("mamba",) * 4,
    moe_positions=tuple(range(10)),
    moe_experts=72,
    moe_top_k=10,
    moe_d_ff=768,
    moe_shared_d_ff=1536,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
    ssm_conv_bias=True,
    nope=True,
    attention_multiplier=0.0078125,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=10, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
    vocab=512, head_dim=16, moe_experts=8, moe_top_k=2, moe_d_ff=32,
    moe_shared_d_ff=48, ssm_state=16, ssm_head_dim=16, ssm_chunk=8, tp=1,
    kv_block=16, moe_group_size=32, attention_multiplier=1 / 16,
)
