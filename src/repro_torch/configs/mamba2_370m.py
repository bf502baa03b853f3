"""mamba2-370m [ssm]: 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060; unverified]

The most CFA-representative architecture: the SSD chunk scan is a 1-D
uniform-dependence tiled loop whose inter-chunk states are flow-out facets
(DESIGN.md §Arch-applicability)."""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1,   # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    head_dim=64,
    period=("mamba",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, vocab=512, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=8, tp=1, kv_block=16,
)
