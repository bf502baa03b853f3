"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024 vocab=50304,
MoE 64 experts top-8 on every layer.  [arXiv:2409.02060; hf]"""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    head_dim=128,
    rope_theta=10_000.0,
    qk_norm=True,
    period=("attn",),
    moe_positions=(0,),
    moe_experts=64,
    moe_top_k=8,
    moe_d_ff=1024,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
    vocab=512, head_dim=16, moe_experts=8, moe_top_k=2, moe_d_ff=32,
    tp=1, kv_block=16, moe_group_size=32,
)
