"""Multi-pod dry run: every (architecture x shape x mesh) cell's step on a
fake world of 256 or 512 ranks — the port of ``repro/launch/dryrun.py``.

Proves the distribution config is coherent without the hardware: sharding
mismatches, shape errors and unsupported collectives surface here.  One
process starts a fake process group (backend ``"fake"`` over
``torch.testing._internal.distributed.fake_pg.FakeStore``) of 256 ranks
(``single``: the 16 x 16 production mesh) or 512 (``multi``: 2 x 16 x 16),
builds ``make_production_mesh`` on it, and runs the cell's step as rank 0
on ``meta`` tensors at the full configuration: forward, backward and
optimizer update for ``train_4k``, the prefill or decode step otherwise.
Nothing is computed and nothing is sent; the kernels' wrappers propagate
shapes only.  Emits one JSON record per cell:

* ``collectives``: per kind (the reference's ``COLLECTIVE_KINDS``) the
  count and the operand bytes of every collective the step makes, read by
  a ``TorchDispatchMode`` over the ``_c10d_functional`` ops (DTensor's
  redistributions), the ``c10d`` ops (``torch.distributed`` calls) and the
  point-to-point ops (``collective-permute`` is send/recv).  DTensor's
  ``CommDebugMode`` is not used: its module hooks break on the port's
  parametrized modules.
* ``flops``: from ``torch.utils.flop_counter.FlopCounterMode``
  (``flops_source`` names it).  It counts matrix-product-class ops
  (matmuls, convolutions, attention) at 2 FLOPs per multiply-add; XLA's
  cost analysis also counts elementwise work, so the two are not the same
  count.
* ``memory``: ``argument_size_in_bytes`` and ``output_size_in_bytes``, this
  rank's local shard shapes of the step's arguments and outputs (by their
  DTensor shards, or the cell's placements), and ``arguments``, the former
  per argument (``params``, ``opt_state``, ``batch``; ``caches``, ...).
* ``no_counterpart``: the reference's fields that have none here, by name —
  none of them is invented.

A skipped cell's record gives ``cell_applicable``'s reason; a cell that
raises is a ``status="error"`` record and the CLI exits 1.

Usage:
    python -m repro_torch.launch.dryrun [--arch A] [--cell C]
        [--mesh single|multi|both] [--out build/dryrun]

Run each world in its own process (the CLI does): the fake group is the
process's default group while a cell runs, and is destroyed after it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.distributed.sharding import use_mesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import SHAPE_CELLS, build_cell, cell_applicable, policy_for
from repro_torch.models.lm import LM

__all__ = ["COLLECTIVE_KINDS", "NO_COUNTERPART", "ARG_NAMES", "CollectiveCounter",
           "fake_world", "local_bytes", "run_cell", "main"]

COLLECTIVE_KINDS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

#: the reference record's fields that have no counterpart here
NO_COUNTERPART = ("temp_size_in_bytes", "alias_size_in_bytes", "generated_code_size_in_bytes",
                  "bytes_accessed", "loop_aware", "hlo_lines")

#: op name (``namespace::name``, overload dropped) -> collective kind
_KIND = {
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "c10d::allreduce_": "all-reduce",
    "c10d::allreduce_coalesced_": "all-reduce",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d::alltoall_": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::send": "collective-permute",
    "c10d::recv_": "collective-permute",
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _op_name(func) -> str:
    schema = getattr(func, "_schema", None)
    return schema.name if schema is not None else str(func)


class CollectiveCounter:
    """Counts collectives by kind while active: a ``TorchDispatchMode``
    over every op, keeping those of :data:`_KIND` with the bytes of their
    tensor operands (the first argument: the tensor or list sent, or
    received into).  ``counts``/``bytes`` per kind; ``other`` counts the
    ``c10d``/``_c10d_functional`` ops of no kind (e.g. broadcast; waits and
    autograd wrappers are not ops that move data)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self
        self.counts = {k: 0 for k in COLLECTIVE_KINDS}
        self.bytes = {k: 0 for k in COLLECTIVE_KINDS}
        self.other: dict[str, int] = {}

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counter._see(func, args)
                return func(*args, **(kwargs or {}))

        self._mode = _Mode()

    def _see(self, func, args) -> None:
        name = _op_name(func)
        kind = _KIND.get(name)
        if kind is None:
            if name.startswith(("c10d::", "_c10d_functional::")) and not any(
                    w in name for w in ("wait", "wrap")):
                self.other[name] = self.other.get(name, 0) + 1
            return
        self.counts[kind] += 1
        self.bytes[kind] += sum(t.numel() * t.element_size()
                                for t in _tensors(args[0] if args else ()))

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)

    def record(self) -> dict:
        return {"bytes": dict(self.bytes), "counts": dict(self.counts), "other": dict(self.other)}


class fake_world:
    """A fake default process group of ``world`` ranks in this process
    (this process is rank 0), destroyed on exit.  Works on torch 2.11 and
    later."""

    def __init__(self, world: int):
        self.world = world

    def __enter__(self):
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=self.world)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()
        return False


#: the names of a cell's arguments, by kind
ARG_NAMES = {"train": ("params", "opt_state", "batch"),
             "prefill": ("params", "tokens", "context"),
             "decode": ("params", "caches", "token", "position")}


def local_bytes(tree, placements, mesh) -> int:
    """Bytes this rank holds of ``tree``'s tensors: a DTensor's local shard;
    a plain tensor divided by the mesh dimensions its placements (a
    parallel tree; None: whole) shard it over.  A model counts its
    parameters' local shards."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(tree, LM):
        return sum(local_bytes(p, None, mesh) for p in tree.parameters())
    if isinstance(tree, DTensor):
        return tree.to_local().numel() * tree.element_size()
    if isinstance(tree, torch.Tensor):
        n = tree.numel() * tree.element_size()
        if placements:
            n //= math.prod(mesh.size(i) for i, pl in enumerate(placements)
                            if isinstance(pl, Shard))
        return n
    if isinstance(tree, dict):
        return sum(local_bytes(v, placements and placements.get(k), mesh)
                   for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v, placements[i] if placements else None, mesh)
                   for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree):
        return sum(local_bytes(getattr(tree, f.name),
                               placements and getattr(placements, f.name), mesh)
                   for f in dataclasses.fields(tree))
    return 0


def _outputs_bytes(cell, out, mesh) -> int:
    """This rank's bytes of the step's outputs: the train step's updated
    model and moments and its metrics; a serving step's logits and caches
    by the cell's out placements."""
    if cell.kind == "train":
        model, opt, metrics = out
        return local_bytes((model, opt, metrics), None, mesh)
    logits, caches = out
    return local_bytes((logits, caches), cell.out_shardings, mesh)


def run_cell(arch: str, cell: str, mesh_kind: str, *, cfg=None, cells=None,
             mesh_shape: tuple | None = None) -> dict:
    """One cell's record on a fake world of 256 (``single``) or 512
    (``multi``) ranks.  ``cfg``/``cells`` override the configuration and the
    shape table, ``mesh_shape`` (sizes, axis names) the production mesh
    (tests cut them)."""
    from torch.utils.flop_counter import FlopCounterMode

    import repro_torch.launch.specs as specs

    cfg = cfg or get_config(arch)
    rec = {"arch": arch, "cell": cell, "mesh": mesh_kind}
    ok, why = cell_applicable(cfg, cell)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    multi = mesh_kind == "multi"
    saved = specs.SHAPE_CELLS
    try:
        if cells is not None:
            specs.SHAPE_CELLS = cells
        world = math.prod(mesh_shape[0]) if mesh_shape else 512 if multi else 256
        with fake_world(world):
            if mesh_shape:
                from torch.distributed.device_mesh import init_device_mesh

                mesh = init_device_mesh("cpu", mesh_shape[0], mesh_dim_names=mesh_shape[1])
            else:
                mesh = make_production_mesh(multi_pod=multi, device="cpu")
            t0 = time.time()
            with use_mesh(mesh, **policy_for(cfg, cell)):
                c = build_cell(cfg, cell, mesh)
                arguments = {name: local_bytes(a, sh, mesh) for name, a, sh in
                             zip(ARG_NAMES[c.kind], c.args, c.in_shardings)}
                t1 = time.time()
                flops = FlopCounterMode(display=False)
                with CollectiveCounter() as coll, flops:
                    out = c.step(*c.args)
            t2 = time.time()
            rec.update(
                status="ok",
                t_build_s=round(t1 - t0, 2),
                t_step_s=round(t2 - t1, 2),
                flops=float(flops.get_total_flops()),
                flops_source="torch.utils.flop_counter.FlopCounterMode",
                memory={"argument_size_in_bytes": sum(arguments.values()),
                        "output_size_in_bytes": _outputs_bytes(c, out, mesh),
                        "arguments": arguments},
                collectives=coll.record(),
                n_devices=mesh.size(),
                no_counterpart=list(NO_COUNTERPART),
            )
    except Exception as e:  # a failure here is a bug in the system
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
    finally:
        specs.SHAPE_CELLS = saved
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="architecture id (default all)")
    ap.add_argument("--cell", default=None, choices=[*SHAPE_CELLS, None])
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else ARCH_NAMES
    cells = [args.cell] if args.cell else list(SHAPE_CELLS)
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]

    n_fail = 0
    for arch in archs:
        for cell in cells:
            for mk in meshes:
                path = out_dir / f"{arch}__{cell}__{mk}.json"
                if path.exists():
                    rec = json.loads(path.read_text())
                    if rec.get("status") in ("ok", "skipped"):
                        print(f"[cached] {arch} {cell} {mk}: {rec['status']}")
                        continue
                rec = run_cell(arch, cell, mk)
                path.write_text(json.dumps(rec, indent=1))
                line = f"{arch} {cell} {mk}: {rec['status']}"
                if rec["status"] == "ok":
                    mem = rec["memory"]
                    line += (f" flops={rec['flops']:.3e} step={rec['t_step_s']}s"
                             f" perdev_args={mem['argument_size_in_bytes'] / 2 ** 30:.2f}GiB"
                             f" collectives={rec['collectives']['counts']}")
                elif rec["status"] == "error":
                    n_fail += 1
                    line += f" !! {rec['error'][:200]}"
                print(line, flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
