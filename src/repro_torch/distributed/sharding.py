"""Sharding rules, the active mesh, and the memory ports of one device.

The PyTorch counterpart of the reference's ``repro/distributed/sharding.py``.

**Sharding rules.**  Axis conventions (``repro_torch.launch.mesh``):

* ``pod``   — outer data-parallel axis across pods;
* ``data``  — data parallelism + FSDP parameter sharding;
* ``model`` — tensor / expert parallelism.

Model specs are the reference's logical specs: a :class:`P` holds one entry
per tensor dimension, each None (replicated), a mesh-axis name, or a tuple of
names (the dimension split over several axes, major axis first).  The
reference's two robustness rules hold: :func:`sanitize_spec` drops a mesh
axis from a dimension whose size it does not divide (and axes the mesh does
not have), and a None mesh turns every rule into a no-op.  A mesh is a
``torch.distributed`` ``DeviceMesh`` (its ``mesh_dim_names`` and ``shape``
give the axes and sizes), or anything whose ``shape`` maps axis names to
sizes (the reference tests' fake mesh).  :func:`named` turns a spec into
the DTensor placements, one per mesh dimension, that stand in for the
reference's ``NamedSharding``: ``Shard(d)`` on each mesh dimension that
splits tensor dimension ``d``, ``Replicate()`` on the others.  A DTensor
splits a dimension over several mesh dimensions in mesh order, so a spec
whose axis tuple runs against the mesh's order raises instead of falling
back to another layout.

The port's models call no :func:`constrain`: the reference's constraints on
activations have no numeric effect, and the port keeps each layer's compute
whole on every rank of a model group (``repro_torch.models.lm.shard_lm``).
:func:`constrain` and :func:`constrain_tree` redistribute DTensors (the
train step pins gradients to the parameters' placements with the latter).
The reference's ``shard_map_compat`` is a shim between JAX versions and has
no counterpart: :meth:`PortMesh.run` does its job for the per-port kernels.

**Memory ports** (``port_mesh``/``shard_facets``).  The reference folds its
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
import math
import threading
from typing import Any, Callable, Iterable, Mapping, Sequence

import torch

from repro_torch.runtime import resolve_device

__all__ = [
    "P", "DP_AXES", "set_mesh", "get_mesh", "get_dp_axes", "get_drop_axes", "use_mesh",
    "sanitize_spec", "named", "constrain", "sanitize_tree", "batch_spec",
    "translate_specs", "constrain_tree", "full_tensor", "PortMesh", "port_mesh", "shard_facets",
]


class P(tuple):
    """A logical partition spec: one entry per tensor dimension (None, an
    axis name, or a tuple of axis names); missing trailing dimensions are
    replicated.  A tuple, so it equals the reference's ``PartitionSpec``
    converted with ``tuple()``."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


_STATE = threading.local()

# logical data-parallel axes; ``pod`` is silently absent on single-pod meshes
DP_AXES = ("pod", "data")


def set_mesh(mesh) -> None:
    _STATE.mesh = mesh


def get_mesh():
    return getattr(_STATE, "mesh", None)


def get_dp_axes() -> tuple:
    return getattr(_STATE, "dp_axes", DP_AXES)


def get_drop_axes() -> frozenset:
    return getattr(_STATE, "drop_axes", frozenset())


class use_mesh:
    """Install the active mesh + parallelism policy (per thread).

    ``dp_axes``: mesh axes carrying the batch dimension (a per-arch policy:
    small models fold 'model' into data parallelism).  ``drop_axes``: axes
    erased from :func:`constrain` (pure data parallelism replicates what
    tensor parallelism would shard)."""

    def __init__(self, mesh, *, dp_axes: tuple = DP_AXES, drop_axes=frozenset()):
        self.mesh = mesh
        self.dp_axes = tuple(dp_axes)
        self.drop_axes = frozenset(drop_axes)

    def __enter__(self):
        self.prev = (get_mesh(), get_dp_axes(), get_drop_axes())
        _STATE.mesh = self.mesh
        _STATE.dp_axes = self.dp_axes
        _STATE.drop_axes = self.drop_axes
        return self.mesh

    def __exit__(self, *exc):
        _STATE.mesh, _STATE.dp_axes, _STATE.drop_axes = self.prev
        return False


def _mesh_axes(mesh) -> dict[str, int]:
    """The mesh's axes in mesh order, each with its size: a ``DeviceMesh``'s
    ``mesh_dim_names`` and ``shape``, or a mesh whose ``shape`` is already
    such a mapping."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ValueError("a mesh needs named dimensions (mesh_dim_names)")
    return dict(zip(names, mesh.shape))


def _axis_size(axes_sizes: Mapping[str, int], axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(axes_sizes.get(a, 1) for a in axes)


def _present(axes_sizes: Mapping[str, int], axes):
    """Drop mesh axes that do not exist in this mesh (e.g. 'pod' single-pod)."""
    if axes is None:
        return None
    if isinstance(axes, str):
        return axes if axes in axes_sizes else None
    kept = tuple(a for a in axes if a in axes_sizes)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def sanitize_spec(spec: P, shape: Sequence[int], mesh) -> P:
    """Adapt a logical spec to a concrete (mesh, shape): drop absent axes;
    for multi-axis dims keep the longest prefix whose product divides the
    dim (e.g. batch=128 over ('data','model')=256 degrades to 'data'=16)."""
    if mesh is None:
        return P()
    sizes = _mesh_axes(mesh)
    dims = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim_size, axes in zip(shape, dims):
        axes = _present(sizes, axes)
        if axes is None:
            out.append(None)
            continue
        tup = axes if isinstance(axes, tuple) else (axes,)
        while tup and dim_size % _axis_size(sizes, tup) != 0:
            tup = tup[:-1]
        if not tup:
            out.append(None)
        else:
            out.append(tup if len(tup) > 1 else tup[0])
    return P(*out)


def named(spec: P, shape: Sequence[int], mesh) -> tuple | None:
    """The DTensor placements of ``spec`` sanitized for (``shape``,
    ``mesh``), one per mesh dimension in mesh order; None without a mesh.
    Raises where the spec splits a dimension over axes in an order other
    than the mesh's, or names one mesh axis on two dimensions: no DTensor
    layout is that spec."""
    if mesh is None:
        return None
    from torch.distributed.tensor import Replicate, Shard

    order = list(_mesh_axes(mesh))
    placements: list = [Replicate()] * len(order)
    for d, axes in enumerate(sanitize_spec(spec, shape, mesh)):
        if axes is None:
            continue
        tup = axes if isinstance(axes, tuple) else (axes,)
        idx = [order.index(a) for a in tup]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec} splits dimension {d} over {tup}, against the mesh's "
                             f"axis order {tuple(order)}: a DTensor splits a dimension over "
                             f"mesh dimensions in mesh order only")
        for i in idx:
            if isinstance(placements[i], Shard):
                raise ValueError(f"spec {spec} names mesh axis {order[i]!r} on two dimensions")
            placements[i] = Shard(d)
    return tuple(placements)


def _drop(axes, drop: frozenset):
    if axes is None:
        return None
    tup = axes if isinstance(axes, tuple) else (axes,)
    kept = tuple(a for a in tup if a not in drop)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def _place(x: torch.Tensor, spec: P, mesh):
    """``x`` laid out by ``spec`` on ``mesh``: a DTensor redistributed; a
    plain tensor (the same full value on every rank) distributed, each rank
    keeping its own slice with no communication."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    placements = named(spec, x.shape, mesh)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def constrain(x: torch.Tensor, *spec_dims):
    """``x`` laid out by a spec against the active mesh (no-op without one).

    Accepts either a ready spec (``constrain(x, batch_spec(...))``) or bare
    dims (``constrain(x, 'data', None)``).  A DTensor is redistributed; a
    plain tensor is taken as the same full value on every rank and becomes
    a DTensor holding this rank's slice."""
    mesh = get_mesh()
    if mesh is None:
        return x
    if len(spec_dims) == 1 and isinstance(spec_dims[0], P):
        spec = spec_dims[0]
    else:
        spec = P(*spec_dims)
    drop = get_drop_axes()
    if drop:
        spec = P(*[_drop(a, drop) for a in spec])
    return _place(x, spec, mesh)


def _tree_map(fn: Callable, tree, *rest):
    """``fn`` over the :class:`P` leaves of ``tree`` and the matching
    entries of ``rest`` (trees of the same structure down to those leaves):
    dicts, lists, tuples and dataclass instances are walked."""
    if isinstance(tree, P):
        return fn(tree, *rest)
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    raise TypeError(f"a spec tree holds {type(tree).__name__} where a P was expected")


def sanitize_tree(specs: Any, shapes: Any, mesh) -> Any:
    """Map :func:`named` over parallel (spec, shape) trees -> placements
    (None leaves without a mesh); a shape entry may be anything with a
    ``shape``."""
    return _tree_map(
        lambda s, shp: named(s, shp.shape if hasattr(shp, "shape") else shp, mesh),
        specs, shapes)


def batch_spec(*trailing) -> P:
    """Spec with the batch dim over the policy's data-parallel axes."""
    return P(get_dp_axes(), *trailing)


def translate_specs(tree, *, drop=("model",)):
    """Erase mesh axes from a spec tree (serving weights: no FSDP; pure-DP
    weights: no TP)."""
    dropset = frozenset(drop)
    return _tree_map(lambda s: P(*[_drop(a, dropset) for a in s]), tree)


def constrain_tree(tree, spec_tree):
    """Lay every leaf of ``tree`` out by the matching spec (active mesh;
    no-op without one).

    Used to pin gradients to the parameters' FSDP sharding before the
    optimizer: a gradient that is a pending sum over the data-parallel
    ranks (``Partial``) becomes a reduce-scatter."""
    mesh = get_mesh()
    if mesh is None:
        return tree
    return _tree_map(lambda s, x: _place(x, s, mesh), spec_tree, tree)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """``t`` whole: a DTensor gathered (a collective: every rank of its mesh
    calls it), a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


# ---------------------------------------------------------------------------
# memory ports on one device
# ---------------------------------------------------------------------------


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
