"""Pipeline parallelism demo: 4 stages, 8 microbatches, GPipe schedule.

Runs ``pipeline_apply`` in a child ``python -m torch.distributed.run
--nproc-per-node 4``: 4 gloo ranks, one stage each, on ``--device`` (all
four on the one card, or on the CPU).  gloo sends CPU tensors only, so on
the card each tick's activations are staged through the host; the stages
compute on the card.

    PYTHONPATH=src python -m repro_torch.examples.pipeline_parallel               # on the card
    PYTHONPATH=src python -m repro_torch.examples.pipeline_parallel --device cpu
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

from repro_torch.runtime import resolve_device

S, M, B, D = 4, 8, 2, 64  # stages, microbatches, microbatch size, width


def stage(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    return torch.tanh(h @ w)


def rank_main(device: str) -> int:
    """One rank of the child: the pipelined run against the sequential
    product on the same device; rank 0 prints."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.pipeline import pipeline_apply

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo")
    try:
        mesh = init_device_mesh(dev.type, (dist.get_world_size(),), mesh_dim_names=("pipe",))
        W = torch.as_tensor(np.random.default_rng(0).normal(size=(S, D, D)) * 0.3,
                            dtype=torch.float32, device=dev)
        x = torch.as_tensor(np.random.default_rng(1).normal(size=(M, B, D)),
                            dtype=torch.float32, device=dev)
        out = pipeline_apply(stage, W, x, mesh)
        want = x
        for s in range(S):
            want = stage(W[s], want)
        err = float((out - want).abs().max())
        if dist.get_rank() == 0:
            print(f"{S}-stage pipeline over {M} microbatches on {dev}: err={err:.2e}, "
                  f"bubble fraction (S-1)/(M+S-1) = {S - 1}/{M + S - 1} = "
                  f"{(S - 1) / (M + S - 1):.0%}", flush=True)
        if not err < 1e-5:
            raise AssertionError(f"the pipelined output differs from the sequential one by {err}")
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device every stage runs on (default: cuda)")
    ap.add_argument("--rank", action="store_true",
                    help="run one rank (under torch.distributed.run)")
    args = ap.parse_args(argv)
    if args.rank:
        return rank_main(args.device)
    resolve_device(args.device)  # no card: raise here, before the ranks start
    code = subprocess.call([
        sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
        str(S), "-m", "repro_torch.examples.pipeline_parallel", "--rank",
        "--device", args.device,
    ])
    if code == 0:
        print("OK")
    return code


if __name__ == "__main__":
    raise SystemExit(main())
