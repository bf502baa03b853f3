"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2 — Mamba+attention 1:7 interleave, MoE every
other layer.  [arXiv:2403.19887; hf]

Period of 8: [attn, mamba x7], MoE replacing the dense FFN on odd positions.
Optimizer: adafactor (AdamW state for 398B params does not fit a single
v5e pod; see EXPERIMENTS.md memory table)."""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    head_dim=128,
    rope_theta=10_000.0,
    period=("attn",) + ("mamba",) * 7,
    moe_positions=(1, 3, 5, 7),
    moe_experts=16,
    moe_top_k=2,
    moe_d_ff=24576,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    optimizer="adafactor",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, head_dim=16, moe_experts=4, moe_top_k=2, moe_d_ff=128,
    ssm_state=16, ssm_head_dim=16, ssm_chunk=8, tp=1, kv_block=16,
    moe_group_size=32,
)
