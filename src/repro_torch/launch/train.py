"""Training launcher (the port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --smoke \
        --device cpu --steps 100 --batch 8 --seq 128

``--smoke`` selects the reduced same-family config; without it the full
published config runs on one card (``tp=1``).  Runs on the CUDA device
unless ``--device cpu`` is given.  The loop is fault-tolerant: rerun the
same command after a kill (or after it ends) and it restarts from the
latest checkpoint under ``--ckpt-dir``/<arch>.  ``--multi-pod`` needs the
distribution slice and raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
from pathlib import Path

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.train.loop import Trainer
from repro_torch.train.steps import TrainHParams


def main(argv: list[str] | None = None) -> dict:
    """Run the command; returns ``{"trainer", "start", "log"}``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=str(Path(tempfile.gettempdir()) / "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--metrics-out", default=None)
    args = ap.parse_args(argv)

    if args.multi_pod:
        raise NotImplementedError("--multi-pod needs the port's distribution slice "
                                  "(FSDP/TP on torch.distributed), not yet ported")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, tp=1)  # one card
    hp = TrainHParams(peak_lr=args.lr, accum=args.accum,
                      total_steps=max(args.steps, 10), warmup=min(20, args.steps))
    trainer = Trainer(cfg, batch=args.batch, seq=args.seq,
                      ckpt_dir=Path(args.ckpt_dir) / cfg.name, hp=hp,
                      ckpt_every=args.ckpt_every, device=args.device)
    start = trainer.step
    log = trainer.run(args.steps, log_every=args.log_every)
    for m in log:
        print(" ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in m.items()))
    print(f"ran {trainer.step - start} steps (resumed from {start})")
    if args.metrics_out:
        trainer.save_metrics(args.metrics_out)
    trainer.data.close()
    return {"trainer": trainer, "start": start, "log": log}


if __name__ == "__main__":
    main()
