"""Stencil application through the compiled CFA pipeline + the CUDA tile
kernel.

Runs a gaussian blur (the paper's 5x5 benchmark) over a 2-D grid for several
time steps through ``cfa.compile(..., backend="cuda")``: flow-in gathered
from facet arrays (contiguous block reads), every wave of tiles executed by
one ``stencil_tiles`` launch (on the CPU: its plain PyTorch version),
flow-out written as single-burst facet blocks.

    PYTHONPATH=src python -m repro_torch.examples.stencil_pipeline               # on the card
    PYTHONPATH=src python -m repro_torch.examples.stencil_pipeline --device cpu
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from repro_torch import cfa
from repro_torch.core.cfa import pack_facet
from repro_torch.core.cfa.api import resolve_device
from repro_torch.kernels.stencil import execute_tiles


def stencil_pipeline(device="cuda") -> dict:
    """The blur on ``device``; returns the facets, the ``wavefront``
    backend's facets, the waves and the ``stencil_tiles`` launches."""
    device = resolve_device(device)
    compiled = cfa.compile("gaussian", (4, 32, 32), layout=(2, 16, 16), backend="cuda",
                           device=device)
    print(compiled.describe())

    rng = np.random.default_rng(0)
    image = rng.normal(size=(32, 32)).astype(np.float32)
    inputs = torch.as_tensor(np.stack([image] * compiled.pipeline.specs[0].width),
                             device=device)

    waves = len(compiled.pipeline.wavefronts())
    execute_tiles.launches = 0
    facets = compiled(inputs)  # one tile-kernel launch per wave
    launches = execute_tiles.launches
    n_tiles = math.prod(compiled.pipeline.num_tiles)

    V = compiled.reference(inputs)
    err = float((facets[0][1:] - pack_facet(V, compiled.pipeline.specs[0])).abs().max())
    print(f"{n_tiles} tiles through the cuda backend; oracle err {err:.2e}")
    if not err < 1e-4:
        raise AssertionError(f"the compiled blur differs from the oracle by {err}")

    # the plain wavefront backend produces the same facet storage, bit for bit
    wave = compiled.lower("wavefront")(inputs)
    if not all(torch.equal(facets[k], wave[k]) for k in facets):
        raise AssertionError("the cuda backend differs from wavefront")
    print("cuda == wavefront (bit-exact)")
    print(f"stencil_tiles launches: {launches} ({n_tiles} tiles in {waves} waves)")
    return {"facets": facets, "wavefront": wave, "waves": waves, "launches": launches,
            "err": err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device the stencil compiles for (default: cuda)")
    args = ap.parse_args(argv)
    stencil_pipeline(args.device)
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
