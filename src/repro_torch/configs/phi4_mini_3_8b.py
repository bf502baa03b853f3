"""phi4-mini-3.8b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064 — RoPE SwiGLU GQA.  [arXiv:2412.08905; hf]

TPU note: 24 query heads pad to 32 for tp=16 (DESIGN.md)."""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=200064,
    head_dim=128,
    rope_theta=10_000.0,
    period=("attn",),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=48, n_heads=3, n_kv_heads=1, d_ff=128,
    vocab=512, head_dim=16, tp=1, kv_block=16,
)
