"""GPipe-style pipeline parallelism over a ``pipe`` mesh dimension — the
port of ``repro/distributed/pipeline.py``.

Each rank of the ``pipe`` group is one stage and owns one slice of the
layer stack; microbatches rotate through the stages on the reference's
bubble schedule: S + M - 1 ticks for S stages and M microbatches, bubble
fraction (S-1)/(M+S-1).  Microbatch m is processed by stage s at tick
m + s and retires from the last stage at tick m + S - 1.  The input is the
same on every rank (stage 0 injects); the output is the last stage's
buffer summed over the pipe group (the reference's ``psum``), so every rank
returns the same tensor.

The rotation is point-to-point: each tick a rank sends its output to stage
(s+1) mod S and receives stage (s-1) mod S's, both in one
``torch.distributed.batch_isend_irecv`` so no rank waits on another's send.
**Transfers through the host.**  Where the group's backend cannot move a
tensor of the stage's device (gloo takes CPU tensors only for send and
receive), the rotation and the final sum go through host buffers and the
result comes back onto the stage's device: the stage still computes on its
own device; only the transfer is staged.  A backend that can take neither
the stage's device nor the CPU raises.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["pipeline_apply"]

#: the devices each backend's point-to-point and sum ops take
_TAKES = {"gloo": {"cpu"}, "nccl": {"cuda"}}


def _transfer_device(group, device: torch.device) -> torch.device:
    """The device a tensor of ``device`` crosses the group on: its own when
    the group's backend takes it, else the host; raises when neither."""
    import torch.distributed as dist

    backend = str(dist.get_backend(group))
    by_device: dict[str, str] = {}
    for part in backend.split(","):  # "gloo", or "cpu:gloo,cuda:nccl"
        dev, _, name = part.rpartition(":")
        for d in ([dev] if dev else ["cpu", "cuda", "meta"]):
            by_device[d] = name
    if device.type in _TAKES.get(by_device.get(device.type, ""), ()):
        return device
    if "cpu" in _TAKES.get(by_device.get("cpu", ""), ()):
        return torch.device("cpu")
    raise ValueError(f"the pipe group's backend {backend!r} takes neither {device} tensors "
                     f"nor CPU tensors")


def _stage_params(stage_params, stage: int, n_stages: int, axis: str):
    """This stage's slice of every leaf: row ``stage`` of a plain tensor
    whose leading dim is S, or the one local row of a DTensor sharded
    ``Shard(0)`` over ``axis``."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.utils._pytree import tree_map

    def take(leaf):
        if isinstance(leaf, DTensor):
            names = list(leaf.device_mesh.mesh_dim_names or ())
            if axis not in names or leaf.placements[names.index(axis)] != Shard(0):
                raise ValueError(f"a DTensor stage parameter must be Shard(0) over {axis!r}, "
                                 f"got {leaf.placements} on {tuple(names)}")
            local = leaf.to_local()
            if local.shape[0] != 1:
                raise ValueError(f"a stage's local leading dim must be 1, got "
                                 f"{tuple(local.shape)}")
            return local[0]
        if leaf.shape[0] != n_stages:
            raise ValueError(f"a stage parameter's leading dim must be the {n_stages} stages, "
                             f"got {tuple(leaf.shape)}")
        return leaf[stage]

    return tree_map(take, stage_params)


def _rotate(out: torch.Tensor, group, peers: tuple[int, int], via: torch.device
            ) -> torch.Tensor:
    """Send ``out`` to ``peers[1]`` and receive the tensor ``peers[0]`` sends,
    in one batch; staged on ``via`` (the host) when that is not ``out``'s
    device."""
    import torch.distributed as dist

    send = out.detach().to(via).contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, peers[1], group),
           dist.P2POp(dist.irecv, recv, peers[0], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(out.device)


def pipeline_apply(
    stage_fn: Callable,  # (stage_params, x) -> x (same shape)
    stage_params,  # leaves with leading dim n_stages, or DTensors Shard(0) over ``axis``
    x: torch.Tensor,  # (n_micro, micro_batch, ...) microbatched input, the same on every rank
    mesh,  # a DeviceMesh with an ``axis`` dimension
    *,
    axis: str = "pipe",
) -> torch.Tensor:
    """The reference's GPipe schedule over ``mesh``'s ``axis`` group: every
    rank returns the last stage's outputs for all microbatches, (n_micro,
    micro_batch, ...), on ``x``'s device."""
    import torch.distributed as dist

    names = list(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"the mesh has no {axis!r} dimension: {tuple(names)}")
    dim = names.index(axis)
    n_stages = mesh.size(dim)
    stage = mesh.get_local_rank(dim)
    group = mesh.get_group(dim)
    ranks = dist.get_process_group_ranks(group)
    peers = (ranks[(stage - 1) % n_stages], ranks[(stage + 1) % n_stages])
    via = _transfer_device(group, x.device)
    params = _stage_params(stage_params, stage, n_stages, axis)
    n_micro = x.shape[0]
    cur = torch.zeros_like(x[0])
    buf = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        if stage == 0 and t < n_micro:
            cur = x[t]
        out = stage_fn(params, cur)
        retire = t - (n_stages - 1)
        if stage == n_stages - 1 and retire >= 0:
            buf[retire] = out
        cur = out if n_stages == 1 else _rotate(out, group, peers, via)
    total = (buf * float(stage == n_stages - 1)).to(via)
    dist.all_reduce(total, group=group)
    return total.to(x.device)
