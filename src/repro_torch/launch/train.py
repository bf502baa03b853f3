"""Training launcher (the port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --smoke \
        --device cpu --steps 100 --batch 8 --seq 128
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 8 \
        -m repro_torch.launch.train --arch qwen3-0.6b --smoke --steps 100

``--smoke`` selects the reduced same-family config; without it the full
published config is used.  Runs on the CUDA device unless ``--device cpu``
is given.  The loop is fault-tolerant: rerun the same command after a kill
(or after it ends) and it restarts from the latest checkpoint under
``--ckpt-dir``/<arch>.

Under ``torchrun`` (``WORLD_SIZE`` set) every rank runs this command: the
launcher initialises the process group (``nccl`` on ``cuda:LOCAL_RANK``,
``gloo`` with ``--device cpu``) and builds the mesh as the reference does:
``--smoke`` takes ``mesh_for_devices()``; ``--multi-pod`` takes the
two-pod ``make_production_mesh``, which needs 512 ranks; a full config
takes the one-pod production mesh at 256 ranks and, unlike the reference
(which needs the pod), ``mesh_for_devices()`` at any other world size.
Only rank 0 prints.  Without ``torchrun`` it runs on one device with no
mesh, and ``--multi-pod`` raises.  A full config keeps its published ``tp``
on the production mesh and takes ``tp=1`` otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from pathlib import Path

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.mesh import make_production_mesh, mesh_for_devices
from repro_torch.train.loop import Trainer
from repro_torch.train.steps import TrainHParams

#: the one-pod production mesh's rank count
_POD = 256


def _process_group(device: str) -> torch.device:
    """Initialise the process group from ``torchrun``'s environment; the
    device of this rank."""
    import torch.distributed as dist

    if torch.device(device).type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev)
        return dev
    dist.init_process_group("gloo")
    return torch.device(device)


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

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device, mesh, rank, production = args.device, None, 0, False
    torchrun = "WORLD_SIZE" in os.environ
    if torchrun:
        import torch.distributed as dist

        device = _process_group(args.device)
        rank = dist.get_rank()
        production = args.multi_pod or (not args.smoke and dist.get_world_size() == _POD)
        mesh = (make_production_mesh(multi_pod=args.multi_pod, device=device) if production
                else mesh_for_devices(device=device))
    elif args.multi_pod:
        make_production_mesh(multi_pod=True, device=device)  # raises: no process group
    if not production:
        cfg = dataclasses.replace(cfg, tp=1)
    hp = TrainHParams(peak_lr=args.lr, accum=args.accum,
                      total_steps=max(args.steps, 10), warmup=min(20, args.steps))
    trainer = Trainer(cfg, batch=args.batch, seq=args.seq,
                      ckpt_dir=Path(args.ckpt_dir) / cfg.name, hp=hp, mesh=mesh,
                      ckpt_every=args.ckpt_every, device=device)
    start = trainer.step
    log = trainer.run(args.steps, log_every=args.log_every)
    if rank == 0:
        for m in log:
            print(" ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in m.items()))
        print(f"ran {trainer.step - start} steps (resumed from {start})")
        if args.metrics_out:
            trainer.save_metrics(args.metrics_out)
    trainer.data.close()
    if torchrun:
        dist.destroy_process_group()
    return {"trainer": trainer, "start": start, "log": log}


if __name__ == "__main__":
    main()
