"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attention image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The vision frontend is a STUB: input_specs() provides precomputed patch
embeddings (B, 1600, d_model)."""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    head_dim=128,
    rope_theta=500_000.0,
    period=("attn", "attn", "attn", "attn", "cross"),
    n_context_tokens=1600,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, head_dim=16, n_context_tokens=8, tp=1, kv_block=16,
    moe_group_size=32,
)
