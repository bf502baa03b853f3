"""seamless-m4t-large-v2 [audio]: enc-dec, 24L encoder + 24L decoder,
d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.  [arXiv:2308.11596; hf]

The speech frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, T_frames, d_model); the transformer backbone (conformer-less
simplification, documented in DESIGN.md) is what the cells exercise."""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    head_dim=64,
    rope_theta=10_000.0,
    period=("dec",),
    enc_layers=24,
    n_context_tokens=4096,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=512, head_dim=16, enc_layers=2, n_context_tokens=8, tp=1,
    kv_block=16,
)
