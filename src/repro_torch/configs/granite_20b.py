"""granite-20b [dense]: 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — llama-arch, code.  [arXiv:2405.04324; hf]

TPU note: the single MQA kv head is stored replicated to tp=16 so the KV
cache shards exactly (16x cache memory vs ideal MQA; documented trade)."""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    head_dim=128,
    rope_theta=10_000.0,
    period=("attn",),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab=512, head_dim=16, tp=1, kv_block=16,
)
