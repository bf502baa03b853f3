"""qwen3-0.6b [dense]: 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936 — qk_norm, GQA, head_dim=128.  [hf:Qwen/Qwen3-8B; hf]"""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    period=("attn",),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, head_dim=16, tp=1, kv_block=16,
)
