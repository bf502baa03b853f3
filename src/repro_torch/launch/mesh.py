"""Production mesh construction (the port of ``repro/launch/mesh.py``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of the
initialised process group, one rank per device (``torchrun`` starts them;
the caller initialises the group).  Functions, not module-level constants,
so importing this module touches no process group.
"""
from __future__ import annotations

import math

import torch

__all__ = ["make_production_mesh", "mesh_for_devices"]


def _world() -> int:
    """The initialised process group's size; raises without one."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, e.g. under torchrun)")
    return dist.get_world_size()


def _mesh(shape: tuple, axes: tuple, device: str):
    from torch.distributed.device_mesh import init_device_mesh

    world = _world()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} {axes} mesh needs {math.prod(shape)} ranks, the process "
                         f"group has {world}")
    return init_device_mesh(torch.device(device).type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The reference's target mesh: 16x16 (one pod, 256 devices) or 2x16x16
    (two pods, 512).  Axes: 'pod' x 'data' (DP/FSDP) x 'model' (TP/EP).
    Raises unless the process group's world size is the mesh's size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def mesh_for_devices(n: int | None = None, model: int = 1, device: str = "cuda"):
    """A ("data", "model") mesh of ``n // model`` x ``model`` over the
    process group's ranks; ``n`` (default: the world size) must be the
    world size and divide by ``model``."""
    n = n or _world()
    if n % model:
        raise ValueError(f"{n} ranks do not make a mesh with a model axis of {model}")
    return _mesh((n // model, model), ("data", "model"), device)
