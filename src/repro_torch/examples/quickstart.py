"""Quickstart: Canonical Facet Allocation in five minutes, on the port.

One call — ``cfa.compile`` — picks a burst-friendly layout for the paper's
running example (a 3-D skewed jacobi iteration space), builds the
read->execute->write schedule and binds an execution backend.  The compiled
stencil then runs the tiled computation entirely through facet storage,
verifies against the untiled oracle, and prints the burst statistics that
are the paper's whole point: effective bandwidth under the paper's AXI
port and under the H100's HBM3 burst model (``H100_HBM3``, the card's fit).

    PYTHONPATH=src python -m repro_torch.examples.quickstart               # on the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

On the card the auto backend of a 3-D space is ``cuda``: one
``stencil_tiles`` launch per wave, bit for bit the ``sweep`` backend.
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from repro_torch import cfa
from repro_torch.core.cfa import (IterSpace, Tiling, bounding_box_plan, original_layout_plan,
                                  pack_facet)
from repro_torch.core.cfa.api import resolve_device
from repro_torch.kernels.stencil import execute_tiles

PROGRAM = "jacobi2d5p"
SPACE = (16, 32, 32)


def quickstart(device="cuda") -> dict:
    """The walk-through on ``device``; returns the compiled stencil, its
    facets, the ``sweep`` and ``wavefront`` backends' facets, the waves and
    the ``stencil_tiles`` launches of the compiled run."""
    device = resolve_device(device)
    prog = cfa.get_program(PROGRAM)

    # 1. compile: layout search + planning + backend selection in one call
    compiled = cfa.compile(prog, SPACE, target="axi-zc706",
                           autotune_kwargs=dict(seed=0, budget=64), device=device)
    print(f"dependence pattern ({len(prog.deps.vectors)} vectors): {prog.deps.vectors}")
    print(f"facet widths w_k = {prog.widths}")
    for k, s in compiled.pipeline.specs.items():
        print(f"  facet_{k}: shape {s.shape}  outer={s.outer_axes} inner={s.inner_axes}")
    print(f"autotuned layout: {compiled.layout.key}  "
          f"({compiled.decision.evaluated} candidates scored"
          f"{', cached' if compiled.decision.from_cache else ''})")
    print(f"backend: {compiled.backend} on {compiled.device}  (auto rule: sharded if "
          f"n_ports > 1, cuda on 3-D, wavefront otherwise)")

    # 2. the compiled plan: burst statistics vs the paper's baselines
    tiling = Tiling(compiled.layout.tile)
    rep = compiled.report()
    print(f"\n{'CFA (compiled)':>14}: {compiled.plan.n_bursts:5d} bursts/tile, "
          f"redundancy {compiled.plan.redundancy:5.1%}, "
          f"effective bw {rep.peak_fraction_effective:6.1%} (AXI) "
          f"{compiled.report(cfa.H100_HBM3).peak_fraction_effective:7.3%} (H100 HBM3)")
    for name, plan in [
        ("original", original_layout_plan(IterSpace(SPACE), prog.deps, tiling)),
        ("bounding-box", bounding_box_plan(IterSpace(SPACE), prog.deps, tiling)),
    ]:
        axi = cfa.BandwidthReport.evaluate(plan, cfa.AXI_ZC706)
        hbm = cfa.BandwidthReport.evaluate(plan, cfa.H100_HBM3)
        print(f"{name:>14}: {plan.n_bursts:5d} bursts/tile, "
              f"redundancy {plan.redundancy:5.1%}, "
              f"effective bw {axi.peak_fraction_effective:6.1%} (AXI) "
              f"{hbm.peak_fraction_effective:7.3%} (H100 HBM3)")

    # 3. run it: the whole computation through facet storage
    rng = np.random.default_rng(0)
    inputs = torch.as_tensor(rng.normal(size=(1, 32, 32)), dtype=torch.float32, device=device)
    waves = len(compiled.pipeline.wavefronts())
    execute_tiles.launches = 0
    facets = compiled(inputs)
    launches = execute_tiles.launches

    V = compiled.reference(inputs)  # the untiled oracle
    spec = compiled.pipeline.specs[0]
    err = float((facets[0][1:] - pack_facet(V, spec)).abs().max())
    print(f"\ncompiled stencil == untiled oracle: max err {err:.2e}")
    if not err < 1e-5:
        raise AssertionError(f"the compiled stencil differs from the oracle by {err}")

    # 4. rebind backends: same layout, different executors; the tile kernel
    # computes each point as the plain version does, so all three agree bit for bit
    sweep = compiled.lower("sweep")(inputs)
    wave = compiled.lower("wavefront")(inputs)
    for other, name in ((wave, "wavefront"), (facets, compiled.backend)):
        if not all(torch.equal(sweep[k], other[k]) for k in facets):
            raise AssertionError(f"backend {name} differs from sweep")
    print(f"backends sweep == wavefront == {compiled.backend} (bit-exact)")
    n_tiles = math.prod(compiled.pipeline.num_tiles)
    print(f"stencil_tiles launches: {launches} ({n_tiles} tiles in {waves} waves)")
    return {"compiled": compiled, "facets": facets, "sweep": sweep, "wavefront": wave,
            "waves": waves, "launches": launches, "err": err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device the stencil compiles for (default: cuda)")
    args = ap.parse_args(argv)
    quickstart(args.device)
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
