"""The multi-port tile executor: TPU kernel 1s on CUDA streams.

Replaces the reference package's ``repro/kernels/stencil/ops.py::
execute_tiles_sharded``, a ``shard_map`` of the Pallas tile executor over
the ``port`` mesh axis.  Its counterpart here launches the port's own
hand-written kernel (``csrc/stencil_tiles.cu``, through
:func:`~repro_torch.kernels.stencil.execute_tiles`) once per port, each on
its port's CUDA stream (:class:`~repro_torch.distributed.sharding.PortMesh`),
over the contiguous shard ``halos[p*m:(p+1)*m]``; the shards write one
output tensor.  No new kernel source: the work of every shard is kernel 1's.

What bounds it on the card is what bounds kernel 1 — memory traffic — and
the ports add concurrency, not bandwidth: ``n_ports`` launches of ``m``
tiles each fill the clusters one launch of ``B`` tiles fills, plus one
launch overhead per port.  What bounded the call itself was the host: each
port re-entered ``execute_tiles``, which checked and packed the same
arguments again.  The call is checked and packed once (``_check``), then
each port only launches (``_launch``).  On the CPU the shards run the plain
version (``execute_tiles_ref``) in port order.  A launch error raises;
nothing falls back.  ``execute_tiles_sharded.launches`` counts the per-port
kernel launches it makes.  :func:`stencil_tile_op` is the reference's
kernel-or-plain dispatch over one batch (its ``interpret`` has no
counterpart).
"""
from __future__ import annotations

import torch

from . import stencil as _stencil
from .ref import execute_tiles_ref
from .stencil import execute_tiles

__all__ = ["execute_tiles", "execute_tiles_ref", "stencil_tile_op", "execute_tiles_sharded"]


def stencil_tile_op(
    program_name: str,
    halos: torch.Tensor,  # (B, w0+t0, .., w_{d-1}+t_{d-1})
    tile: tuple[int, ...],
    *,
    use_kernel: bool = True,
) -> torch.Tensor:  # (B, t0, .., t_{d-1})
    """Execute a batch of stencil tiles: through the kernel's wrapper
    (:func:`execute_tiles`, which launches it on a CUDA tensor and runs its
    plain version on a CPU one), or the plain version itself."""
    if use_kernel:
        return execute_tiles(program_name, halos, tile)
    return execute_tiles_ref(program_name, halos, tile)


def execute_tiles_sharded(
    program_name: str,
    halos: torch.Tensor,  # (B, w0+t0, .., w_{d-1}+t_{d-1}), B % mesh.n_ports == 0
    tile: tuple[int, ...],
    mesh,
) -> torch.Tensor:  # (B, t0, .., t_{d-1})
    """Execute a halo batch with one contiguous shard per port.

    The caller pads the batch to a multiple of the port count (the sharded
    executor's ``CFAPipeline._sweep_wavefront_sharded`` does).
    """
    n = mesh.n_ports
    B = halos.shape[0]
    if B % n:
        raise ValueError(
            f"halo batch ({B}) must be a multiple of the mesh axis size ({n}); "
            f"pad the wavefront first"
        )
    if halos.device != mesh.device:
        raise ValueError(f"halos are on {halos.device}, the port mesh on {mesh.device}")
    call = _stencil._check(program_name, halos, tile, None)
    m = B // n
    out = torch.empty((B, *call.tile), dtype=halos.dtype, device=halos.device)
    on_card = halos.device.type == "cuda"

    def shard(p: int) -> None:
        if m == 0:
            return
        sl = slice(p * m, (p + 1) * m)
        if on_card:
            _stencil._launch(call, halos[sl], out[sl])
            execute_tiles_sharded.launches += 1
        else:
            out[sl] = execute_tiles_ref(call.program, halos[sl], call.tile)

    mesh.run(shard, shared=(halos, out))
    return out


#: per-port kernel launches since the last reset (set to 0 to reset)
execute_tiles_sharded.launches = 0
