from .optimizers import (
    OptState,
    adamw_init,
    adafactor_init,
    make_optimizer,
    opt_state_specs,
    global_norm,
    clip_by_global_norm,
)
from .schedule import cosine_warmup

__all__ = [
    "OptState", "adamw_init", "adafactor_init", "make_optimizer", "opt_state_specs",
    "global_norm", "clip_by_global_norm", "cosine_warmup",
]
