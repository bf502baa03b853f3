"""deepseek-67b [dense]: 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400 — llama-arch.  [arXiv:2401.02954; hf]"""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=102400,
    head_dim=128,
    rope_theta=10_000.0,
    period=("attn",),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, head_dim=16, tp=1, kv_block=16,
)
