"""Execution backends behind ``repro_torch.cfa.compile`` — one registry, one gate.

The PyTorch port's counterpart of the reference package's executor
registry: the executors are registered objects with *declared*
capabilities, so backend selection, N-D gating and port-count validation
happen in exactly one place (:func:`check_backend` / :func:`select_backend`).

Registered backends (all return the same payload — the facet-storage dict,
bit-exact across backends):

* ``reference`` — untiled oracle (``reference_volume``) scattered into facet
  storage; the ground truth everything else is compared against.
* ``sweep``     — the tile-by-tile reference loop of §V (Fig. 13).
* ``wavefront`` — anti-diagonal waves of independent tiles, batched.
* ``cuda``      — wavefront sweep through the hand-written CUDA tile
  executor (``repro_torch.kernels.stencil``), one launch per wave; the
  counterpart of the reference's ``pallas`` backend, declared 3-D only —
  the paper's kernel configuration.  On a CPU pipeline the kernel's
  wrapper runs its plain PyTorch version.

Every backend of this slice implements the paper's redundant facet storage
on one port; the irredundant/compressed disciplines, the multi-port
``sharded`` and the overlapped ``dataflow`` backends arrive with later
slices of the port.

Custom backends register through :func:`register_executor`; the autotuner's
cache key folds :func:`capability_fingerprint` in, so decisions re-search
when the executor capability set changes.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Protocol, runtime_checkable

import torch

from .programs import StencilProgram
from .spaces import IterSpace
from .transform import CFAPipeline

__all__ = [
    "BackendError",
    "Executor",
    "ExecutorCaps",
    "EXECUTORS",
    "register_executor",
    "get_executor",
    "available_backends",
    "ineligible_reason",
    "select_backend",
    "check_backend",
    "capability_fingerprint",
    "host_fingerprint",
]


class BackendError(ValueError):
    """A backend cannot execute the requested (program, space, n_ports)."""


@dataclasses.dataclass(frozen=True)
class ExecutorCaps:
    """Declared capabilities of an execution backend.

    ``ndims`` — iteration-space dimensionalities the backend can execute
    (``None`` = any d >= 2, the ``CFAPipeline`` contract).
    ``multiport`` — whether the backend realises an ``n_ports > 1`` facet
    repartition (anything else requires ``n_ports == 1``).
    ``kernels`` — whether the backend drives the hand-written kernels.
    ``storages`` — the facet storage disciplines the backend implements
    (``repro_torch.core.cfa.irredundant.STORAGE_MODES``).
    ``overlap`` — whether the backend overlaps fetch/compute/commit
    (Fig. 13 DATAFLOW); sequential backends should be modeled with
    ``BurstModel.time(..., overlap=False)``.
    """

    ndims: tuple[int, ...] | None = None
    multiport: bool = False
    kernels: bool = False
    storages: tuple[str, ...] = ("redundant",)
    overlap: bool = False
    description: str = ""


@runtime_checkable
class Executor(Protocol):
    """An execution backend: runs a built pipeline over concrete inputs.

    ``execute`` consumes the live-in planes and returns the facet-storage
    dict — the exact payload of ``CFAPipeline._sweep`` — so results from
    any backend compare bit-for-bit.
    """

    name: str
    caps: ExecutorCaps

    def execute(
        self,
        pipeline: CFAPipeline,
        inputs: torch.Tensor,
        *,
        dtype=torch.float32,
        n_ports: int = 1,
        **opts,
    ) -> dict[int, torch.Tensor]: ...


@dataclasses.dataclass(frozen=True)
class _FnExecutor:
    """An Executor wrapping a plain function (the built-in backends).

    ``opts_allowed`` is the backend's call-option surface; anything else is
    rejected loudly — a typo'd option must not run silently.
    """

    name: str
    caps: ExecutorCaps
    fn: Callable[..., dict[int, torch.Tensor]]
    opts_allowed: tuple[str, ...] = ()

    def execute(self, pipeline, inputs, *, dtype=torch.float32, n_ports=1, **opts):
        unknown = sorted(set(opts) - set(self.opts_allowed))
        if unknown:
            raise TypeError(
                f"backend {self.name!r} does not accept option(s) {unknown}; "
                f"allowed: {sorted(self.opts_allowed) or 'none'}"
            )
        return self.fn(pipeline, inputs, dtype=dtype, n_ports=n_ports, **opts)


# --------------------------------------------------------------------------
# Built-in backends
# --------------------------------------------------------------------------


def _reference(pipeline: CFAPipeline, inputs, *, dtype, n_ports=1):
    """Untiled oracle scattered into facet storage.

    ``reference_volume`` computes every plane over the full space; the
    volume's tile blocks are then committed through the very same
    ``copy_out`` the tiled executors use (``copy_out`` only reads the halo
    buffer's interior), so the returned facets are directly comparable."""
    inputs = torch.as_tensor(inputs).to(device=pipeline.device, dtype=dtype)
    V = pipeline.reference_volume(inputs).to(dtype)
    facets = pipeline.load_inputs(pipeline.init_facets(dtype), inputs)
    w = pipeline.widths
    t = pipeline.tiling.sizes
    interior = pipeline._interior_slices(w)
    H = torch.zeros(tuple(wa + ta for wa, ta in zip(w, t)), dtype=dtype,
                    device=pipeline.device)
    for tile in itertools.product(*(range(n) for n in pipeline.num_tiles)):
        H[interior] = V[tuple(slice(q * ta, (q + 1) * ta) for q, ta in zip(tile, t))]
        facets = pipeline.copy_out(facets, tile, H)
    return facets


def _sweep(pipeline: CFAPipeline, inputs, *, dtype, n_ports=1):
    return pipeline._sweep(inputs, dtype)


def _wavefront(pipeline: CFAPipeline, inputs, *, dtype, n_ports=1):
    return pipeline._sweep_wavefront(inputs, dtype, use_kernel=False)


def _cuda(pipeline: CFAPipeline, inputs, *, dtype, n_ports=1):
    return pipeline._sweep_wavefront(inputs, dtype, use_kernel=True)


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

EXECUTORS: dict[str, Executor] = {}


def register_executor(executor: Executor, *, overwrite: bool = False) -> Executor:
    """Register a backend under ``executor.name`` (also usable on custom
    Executor objects from outside this module)."""
    if not overwrite and executor.name in EXECUTORS:
        raise ValueError(f"backend {executor.name!r} is already registered")
    EXECUTORS[executor.name] = executor
    return executor


def get_executor(name: str) -> Executor:
    try:
        return EXECUTORS[name]
    except KeyError:
        raise BackendError(
            f"unknown backend {name!r}; registered: {sorted(EXECUTORS)}"
        ) from None


register_executor(_FnExecutor(
    "reference",
    ExecutorCaps(description="untiled oracle, scattered into facet storage"),
    _reference,
))
register_executor(_FnExecutor(
    "sweep",
    ExecutorCaps(description="tile-by-tile reference loop (paper §V)"),
    _sweep,
))
register_executor(_FnExecutor(
    "wavefront",
    ExecutorCaps(description="batched anti-diagonal tile waves"),
    _wavefront,
))
register_executor(_FnExecutor(
    "cuda",
    ExecutorCaps(ndims=(3,), kernels=True,
                 description="wavefront sweep through the hand-written CUDA "
                             "tile executor (one launch per wave, 3-D only)"),
    _cuda,
))


# --------------------------------------------------------------------------
# The one gate: capability validation + auto-selection
# --------------------------------------------------------------------------


def _ineligible_reason(
    executor: Executor,
    program: StencilProgram,
    space: IterSpace,
    n_ports: int,
    storage: str = "redundant",
) -> str | None:
    """Why this backend cannot run (program, space, n_ports, storage);
    None if it can."""
    caps = executor.caps
    if caps.ndims is not None and space.ndim not in caps.ndims:
        return (
            f"backend {executor.name!r} executes "
            f"{'/'.join(f'{n}-D' for n in caps.ndims)} spaces only, but "
            f"{program.name!r} @ {space.sizes} is {space.ndim}-D"
        )
    if n_ports > 1 and not caps.multiport:
        return f"backend {executor.name!r} is single-port, got n_ports={n_ports}"
    if storage not in caps.storages:
        return (
            f"backend {executor.name!r} does not implement "
            f"{storage!r} facet storage (declares {caps.storages})"
        )
    return None


def ineligible_reason(
    executor: Executor,
    program: StencilProgram,
    space: IterSpace,
    n_ports: int = 1,
    storage: str = "redundant",
) -> str | None:
    """Why this backend cannot run (program, space, n_ports, storage);
    ``None`` if it can.  The non-raising form of :func:`check_backend`."""
    return _ineligible_reason(executor, program, space, n_ports, storage)


def check_backend(
    executor: Executor,
    program: StencilProgram,
    space: IterSpace,
    n_ports: int = 1,
    storage: str = "redundant",
) -> None:
    """Validate (program, space, n_ports, storage) against the backend's
    declared capabilities; raises :class:`BackendError` with the eligible
    alternatives spelled out."""
    reason = _ineligible_reason(executor, program, space, n_ports, storage)
    if reason is not None:
        # sorted: the error message must be stable regardless of
        # registration order (matches get_executor's unknown-name error)
        raise BackendError(
            f"{reason}; eligible backends: "
            f"{sorted(available_backends(program, space, n_ports, storage))}"
        )


def available_backends(
    program: StencilProgram, space: IterSpace, n_ports: int = 1,
    storage: str = "redundant",
) -> list[str]:
    """Names of registered backends able to run (program, space, n_ports,
    storage)."""
    return [
        name for name, ex in EXECUTORS.items()
        if _ineligible_reason(ex, program, space, n_ports, storage) is None
    ]


def select_backend(
    program: StencilProgram, space: IterSpace, n_ports: int = 1,
    storage: str = "redundant",
    overlap: bool = False,
) -> str:
    """The ``backend="auto"`` rule, in one place:

    * ``n_ports > 1`` or ``overlap=True`` — no backend of the port realises
      them yet (the ``sharded`` and ``dataflow`` slices): raises
      :class:`BackendError`;
    * 3-D spaces → ``cuda`` (the paper's kernel configuration), when it
      implements the storage discipline;
    * anything else → ``wavefront`` (dimension-generic, batched).
    """
    if n_ports > 1:
        raise BackendError(
            f"n_ports={n_ports}: the PyTorch port has no multi-port backend "
            f"yet (the sharded slice); compile with n_ports=1"
        )
    if overlap:
        raise BackendError(
            "overlap=True: the PyTorch port has no overlapped backend yet "
            "(the dataflow slice); compile with overlap=False"
        )
    if space.ndim == 3 and storage in EXECUTORS["cuda"].caps.storages:
        return "cuda"
    return "wavefront"


def host_fingerprint() -> list[list[str]]:
    """Stable identity of the machine a measurement ran on.

    Folded into the autotune cache key for ``score="measured"`` decisions:
    a wall-clock ranking measured on one host must not be silently reused
    on another.
    """
    import platform

    device = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    return [
        ["machine", platform.machine()],
        ["system", platform.system()],
        ["python", platform.python_version()],
        ["torch", torch.__version__],
        ["cuda", str(torch.version.cuda)],
        ["device", device],
    ]


def capability_fingerprint() -> list[list]:
    """Stable summary of the registered backend capability set.

    Folded into the autotune cache key: a decision computed under one
    backend capability envelope (dimensions, ports, storage disciplines)
    must not be silently reused after it changes.
    """
    return [
        [name, list(ex.caps.ndims) if ex.caps.ndims is not None else None,
         ex.caps.multiport, ex.caps.kernels, list(ex.caps.storages),
         ex.caps.overlap]
        for name, ex in sorted(EXECUTORS.items())
    ]
