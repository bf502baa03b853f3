"""Memory ports on one device: the ``sharded`` backend's fabric.

The PyTorch counterpart of ``port_mesh``/``shard_facets`` of the
reference's ``repro/distributed/sharding.py``.  The reference folds its
ports onto however many JAX devices exist (port ``p`` -> device ``p mod
size``).  On one H100 a port is a CUDA stream instead: a :class:`PortMesh`
holds ``n_ports`` ports on the caller's device, each CUDA port with its own
``torch.cuda.Stream``, so the shard count is ``n_ports`` on every device.
On the CPU (asked for explicitly, as the tests do) the ports run one after
another in port order.

:meth:`PortMesh.run` is the fork/join every per-port launch goes through:
it records an event on the caller's stream, makes each port stream wait on
it, runs one port's work inside ``torch.cuda.stream(port)``, records an
event per port, and makes the caller's stream wait on all of them.  Tensors
made on the caller's stream and touched by a port are ``record_stream``-ed
onto that port, so the caching allocator cannot hand their memory out while
a port still reads or writes it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Mapping

import torch

__all__ = ["PortMesh", "port_mesh", "shard_facets"]


@dataclasses.dataclass(frozen=True, eq=False)
class PortMesh:
    """``n_ports`` memory ports on one device.

    ``streams`` holds one CUDA stream per port on a CUDA device and is
    empty on the CPU.  ``axis`` names the mesh axis (the reference's mesh
    axis name, ``"port"``), checked by the executors that take it.
    """

    n_ports: int
    device: torch.device
    axis: str = "port"
    streams: tuple = ()

    def port_device(self, p: int) -> torch.device:
        """The device of mesh port ``p``: every port shares the mesh's."""
        if not 0 <= p < self.n_ports:
            raise IndexError(f"port {p} is outside the mesh's {self.n_ports} ports")
        return self.device

    def run(self, work: Callable[[int], None],
            shared: Iterable[torch.Tensor] = ()) -> None:
        """Run ``work(p)`` for every port ``p``: on the CPU in port order;
        on a CUDA device each on its port's stream, ordered after the work
        already queued on the caller's stream, and with the caller's stream
        ordered after every port's work when this returns (no host wait).
        ``shared`` are the caller-stream tensors the ports touch."""
        if not self.streams:
            for p in range(self.n_ports):
                work(p)
            return
        caller = torch.cuda.current_stream(self.device)
        ready = caller.record_event()
        shared = list(shared)
        done = []
        for p, stream in enumerate(self.streams):
            stream.wait_event(ready)
            for t in shared:
                t.record_stream(stream)
            with torch.cuda.stream(stream):
                work(p)
            done.append(stream.record_event())
        for ev in done:
            caller.wait_event(ev)


def port_mesh(n_ports: int, device: "torch.device | str" = "cuda",
              axis: str = "port") -> PortMesh:
    """``n_ports`` ports on ``device`` (the CUDA device unless the caller
    asks for the CPU; a missing card raises).  One CUDA stream per port."""
    if n_ports <= 0:
        raise ValueError(f"n_ports must be positive: {n_ports}")
    from repro_torch.core.cfa.api import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        streams = tuple(torch.cuda.Stream(dev) for _ in range(n_ports))
        return PortMesh(n_ports, dev, axis, streams)
    if dev.type != "cpu":
        raise ValueError(f"ports live on a CUDA device or the CPU, got {dev}")
    return PortMesh(n_ports, dev, axis)


def shard_facets(facets: Mapping[int, torch.Tensor],
                 facet_to_port: Mapping[int, int],
                 mesh: PortMesh) -> dict[int, torch.Tensor]:
    """Place each facet tensor on its assigned port's device: facet ``k``
    lives on mesh port ``facet_to_port[k] mod n_ports`` (ports beyond the
    mesh fold back, as in the reference; unassigned facets go to port 0).

    Every port of a :class:`PortMesh` shares the mesh's device, so placement
    moves a facet only when it lies on another device; a facet already
    resident there is kept as it is — what the reference does for facets
    already on their port's device."""
    out = {}
    for k, v in facets.items():
        dev = mesh.port_device(int(facet_to_port.get(k, 0)) % mesh.n_ports)
        out[k] = v if v.device == dev else v.to(dev)
    return out
