"""End-to-end driver: train a ~100M-parameter dense LM with the full stack —
synthetic packed data, AdamW + cosine schedule, remat, async fault-tolerant
checkpointing.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300     # on the card
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 2 --batch 1 --seq 64 --device cpu

Every run of the command trains ``--steps`` more steps.  Stop it mid-run —
kill it, or create the preemption sentinel ``<ckpt-dir>/PREEMPT``, which
makes the trainer save a checkpoint after the step it is in and exit — and
rerun it (after removing the sentinel): it resumes from the latest
checkpoint, and its losses are the ones an uninterrupted run gives at the
same steps (each logged loss is printed in full, so two runs compare
exactly).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.data.pipeline import PackedDocs
from repro_torch.models.config import ArchConfig
from repro_torch.runtime import resolve_device
from repro_torch.train.loop import Trainer
from repro_torch.train.steps import TrainHParams

# ~114M parameters by the reference's comment (param_count() 125829120, embedding and
# head included): a llama-family dense config
CFG_100M = ArchConfig(
    name="demo-100m",
    family="dense",
    n_layers=10,
    d_model=640,
    n_heads=10,
    n_kv_heads=5,
    d_ff=2560,
    vocab=50304,
    head_dim=64,
    rope_theta=10_000.0,
    period=("attn",),
    tp=1,
    kv_block=64,
)
#: the reference example's checkpoint directory, under this host's temporary directory
DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_demo_100m")


def run(cfg: ArchConfig = CFG_100M, *, steps: int = 300, batch: int = 4, seq: int = 256,
        ckpt_dir: str = DEFAULT_CKPT_DIR, device="cuda",
        log_every: int = 5) -> dict:
    """Train ``steps`` more steps of ``cfg`` from the latest checkpoint under
    ``ckpt_dir`` (from step 0 when there is none), printing every
    ``log_every``-th step; returns ``{"start", "end", "log", "wall_s",
    "peak_bytes"}`` (``wall_s`` on the host clock around the steps and a
    synchronize, checkpoints included; ``peak_bytes`` None off the card)."""
    device = resolve_device(device)
    print(f"params ~= {cfg.param_count() / 1e6:.0f}M")
    hp = TrainHParams(peak_lr=3e-4, warmup=20, total_steps=steps, remat=True)
    data = PackedDocs(vocab=cfg.vocab, batch=batch, seq=seq)
    try:
        tr = Trainer(cfg, batch=batch, seq=seq, ckpt_dir=ckpt_dir, hp=hp, data=data,
                     ckpt_every=50, device=device)
        start = tr.step
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        log = tr.run(steps, log_every=log_every)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    finally:
        data.close()
    for m in log:
        print(f"step {m['step']:4d}  loss {m['loss']!r}  lr {m['lr']:.2e}  {m['dt']:.3f} s/step")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    n = tr.step - start
    print(f"steps {start + 1}-{tr.step} on {device} in {wall:.3f} s (host clock to a "
          f"synchronize, checkpoints included): {wall / max(n, 1) * 1e3:.3f} ms/step, "
          f"{n * batch * seq / wall:.1f} tokens/s; peak max_memory_allocated "
          + ("not measured off the card" if peak is None else f"{peak / 2 ** 30:.3f} GiB"))
    return {"start": start, "end": tr.step, "log": log, "wall_s": wall, "peak_bytes": peak}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)
    run(CFG_100M, steps=args.steps, batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
        device=args.device)
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
