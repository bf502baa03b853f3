"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 — MoE, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

TPU note: 40 query heads pad to 48 for tp=16 (DESIGN.md)."""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    rope_theta=500_000.0,
    period=("attn",),
    moe_positions=(0,),
    moe_experts=16,
    moe_top_k=1,
    moe_d_ff=8192,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=5, n_kv_heads=1, d_ff=64,
    vocab=512, head_dim=16, moe_experts=4, moe_top_k=1, moe_d_ff=64,
    tp=1, kv_block=16, moe_group_size=32,
)
