#!/usr/bin/env python3
"""Build the PyTorch port's CUDA kernels and drive its main path on one card.

    python3 chip_smoke.py            # needs one CUDA device and nvcc
    python3 chip_smoke.py --steps 64 # cut the main space's time axis

Phases (each raises on failure; the script exits non-zero and prints no
result line unless every phase passed):

1. device   — a CUDA device must exist; prints ``nvidia-smi``'s name and
              power limit;
2. build    — compiles every kernel source from the checkout (one ``nvcc``
              per source, started together) and prints ptxas's register /
              shared-memory lines;
3. kernels  — each kernel against its plain PyTorch version on random
              inputs, every program of ``execute_tiles`` in float32 and
              float64; the difference must be 0 (bit-exact by design);
4. small    — ``repro_torch.cfa.compile(..., backend="cuda")`` on each 3-D
              program at test sizes: facets equal the card's ``sweep``
              backend exactly and the CPU's within float rounding;
5. main     — ``cfa.compile("jacobi2d5p", (256, 1024, 1024))`` (``--steps``
              cuts the 256 time steps; the 1024² grid stays) with the
              autotuned layout and the auto backend (``cuda``), run once on
              seeded float32 inputs; kernel launches must equal the waves,
              facets must equal the card's ``reference`` backend;
6. timing   — each kernel timed with CUDA events at the main path's shapes
              (median of 5 windows of 100 launches after 10 warm-up
              launches), beside its plain version and its bound;
7. the ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

Imports nothing of the JAX package; the port is imported from ``src/``
beside this file.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 0
#: the H100 SXM's published peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
MAIN_PROGRAM = "jacobi2d5p"
MAIN_SPACE = (256, 1024, 1024)
SMALL_CASES = [  # tests/test_passes.py's CASES, 3-D rows
    ("jacobi2d5p", (8, 8, 8), (4, 4, 4)),
    ("jacobi2d9p", (8, 8, 8), (4, 4, 4)),
    ("jacobi2d9p-gol", (8, 8, 8), (4, 4, 4)),
    ("gaussian", (4, 16, 16), (2, 8, 8)),
    ("smith-waterman-3seq", (9, 8, 8), (3, 4, 4)),
]
KERNEL_CASES = [  # (program, tile, batch) for the kernel-vs-plain phase
    ("jacobi2d5p", (4, 8, 8), 3), ("jacobi2d5p", (8, 16, 16), 2),
    ("jacobi2d9p", (4, 8, 8), 3), ("jacobi2d9p-gol", (4, 8, 8), 3),
    ("gaussian", (4, 16, 16), 2), ("smith-waterman-3seq", (6, 8, 8), 3),
    ("heat1d", (8, 32), 4), ("heat3d", (2, 4, 4, 4), 3),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def rng_tensor(rng, shape, dtype, device) -> torch.Tensor:
    return torch.as_tensor(rng.normal(size=shape)).to(device=device, dtype=dtype)


# -- phases ------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), using {torch.cuda.get_device_name(0)}")
    log(smi)
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"[build] {len(secs)} source(s) in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.find_nvcc()}): " + ", ".join(
            f"{k} {v:.2f} s" for k, v in secs.items()))
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                log(f"[build] {name}: {line.strip()}")


def phase_kernels(device) -> float:
    """Every program, both dtypes: the kernel against its plain version."""
    from repro_torch.core.cfa.programs import get_program
    from repro_torch.kernels.stencil import execute_tiles, execute_tiles_ref

    rng = np.random.default_rng(SEED)
    worst = 0.0
    for name, tile, batch in KERNEL_CASES:
        w = get_program(name).widths
        shape = (batch, *(wa + ta for wa, ta in zip(w, tile)))
        for dtype in (torch.float32, torch.float64):
            halos = rng_tensor(rng, shape, dtype, device)
            got = execute_tiles(name, halos, tile)
            want = execute_tiles_ref(name, halos, tile)
            torch.cuda.synchronize()
            err = max_abs(got, want)
            log(f"[kernels] stencil_tiles {name} tile={tile} B={batch} "
                f"{str(dtype)[6:]}: max|kernel-plain| = {err!r}")
            if not (torch.isfinite(got).all() and err == 0.0):
                raise AssertionError(f"stencil_tiles {name} {dtype}: differs "
                                     f"from its plain version by {err!r}")
            worst = max(worst, err)
    return worst


def phase_small(device) -> None:
    """The front door on each 3-D program: cuda == sweep on the card, and
    the card agrees with the CPU (float rounding tolerance, expected 0)."""
    from repro_torch import cfa

    for name, space, tile in SMALL_CASES:
        w0 = cfa.get_program(name).widths[0]
        x = np.random.default_rng(SEED).normal(size=(w0, *space[1:]))
        compiled = cfa.compile(name, space, layout=tile, backend="cuda",
                               device=device)
        for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            got = compiled(x, dtype=dtype)
            ref = compiled.lower("sweep")(x, dtype=dtype)
            cpu = cfa.compile(name, space, layout=tile, backend="sweep",
                              device="cpu")(x, dtype=dtype)
            torch.cuda.synchronize()
            exact = all(torch.equal(got[k], ref[k]) for k in ref)
            err_cpu = max(max_abs(got[k].cpu(), cpu[k]) for k in cpu)
            log(f"[small] {name} @ {space} tile {tile} {str(dtype)[6:]}: "
                f"cuda==sweep on card: {exact}, max|card-cpu| = {err_cpu!r}")
            if not exact or not err_cpu <= tol:
                raise AssertionError(f"{name} {dtype}: cuda backend disagrees")


def phase_main(device, space=MAIN_SPACE) -> dict:
    """The full-size main path, once, through the front door."""
    from repro_torch import cfa
    from repro_torch.kernels.stencil import execute_tiles

    t0 = time.perf_counter()
    compiled = cfa.compile(MAIN_PROGRAM, space, device=device)
    t_compile = time.perf_counter() - t0
    pipe = compiled.pipeline
    waves = pipe.wavefronts()
    n_tiles = math.prod(pipe.num_tiles)
    log(f"[main] {compiled.describe()}")
    log(f"[main] compile {t_compile:.2f} s; layout {compiled.layout.key}, "
        f"backend {compiled.backend}, {n_tiles} tiles in {len(waves)} waves "
        f"(largest {max(len(w) for w in waves)})")
    if compiled.backend != "cuda":
        raise AssertionError(f"auto backend is {compiled.backend!r}, not 'cuda'")
    w0 = compiled.program.widths[0]
    x = torch.as_tensor(np.random.default_rng(SEED).normal(
        size=(w0, *space[1:])), dtype=torch.float32).to(device)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    execute_tiles.launches = 0
    t0 = time.perf_counter()
    facets = compiled(x, dtype=torch.float32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = execute_tiles.launches
    peak = torch.cuda.max_memory_allocated()
    points = math.prod(space)
    log(f"[main] cuda backend: {wall:.3f} s wall (host clock around "
        f"synchronize), {points / wall:.4g} points/s, {launches} kernel "
        f"launches, max_memory_allocated {peak / 2**30:.3f} GiB")
    if launches != len(waves):
        raise AssertionError(f"{launches} kernel launches for {len(waves)} waves")

    t0 = time.perf_counter()
    ref = compiled.lower("reference")(x, dtype=torch.float32)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    for k in ref:
        if facets[k].shape != ref[k].shape or not torch.isfinite(facets[k]).all():
            raise AssertionError(f"facet {k}: bad shape or non-finite values")
    diffs = {k: max_abs(facets[k], ref[k]) for k in ref}
    log(f"[main] reference backend {t_ref:.3f} s; max|cuda-reference| per "
        f"facet {diffs}")
    if any(v != 0.0 for v in diffs.values()):
        raise AssertionError(f"cuda backend differs from reference: {diffs}")
    return {"launches": launches, "tile": compiled.pipeline.tiling.sizes,
            "widths": compiled.program.widths, "largest_wave": max(len(w) for w in waves)}


def _time_ms(fn, iters: int, warmup: int = 10, repeats: int = 5) -> tuple[float, float, float]:
    """(median, min, max) ms per call over ``repeats`` CUDA-event windows of
    ``iters`` back-to-back calls each, after ``warmup`` calls (which also
    lift the card's clocks after the host-bound phases)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    per_call = []
    for _ in range(repeats):
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(stop) / iters)
    return statistics.median(per_call), min(per_call), max(per_call)


def _stencil_bound(name: str, halos: torch.Tensor, tile) -> tuple[float, str]:
    """Least time for the call: each input byte read once and each output
    byte written once at peak bandwidth, against its flops at peak rate."""
    from repro_torch.core.cfa.programs import COMBINE_GOL, term_table

    tt = term_table(name)
    n = len(tt.depth)
    # n products/sums (or max) and n-1 combines; gol: n-1 adds, *2, /9, -
    flops_pt = n + 2 if tt.combine == COMBINE_GOL else 2 * n - 1
    out_elems = halos.shape[0] * math.prod(tile)
    nbytes = (halos.numel() + out_elems) * halos.element_size()
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = out_elems * flops_pt / PEAK_FLOPS[halos.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timing(device, main: dict) -> list[dict]:
    from repro_torch.kernels.stencil import execute_tiles, execute_tiles_ref

    rng = np.random.default_rng(SEED)
    w = main["widths"]
    shapes = [("main path (autotuned)", main["tile"], main["largest_wave"]),
              ("paper 64^3 tile", (64, 64, 64), main["largest_wave"])]
    rows = []
    for label, tile, batch in shapes:
        halos = rng_tensor(rng, (batch, *(wa + ta for wa, ta in zip(w, tile))),
                           torch.float32, device)
        err = max_abs(execute_tiles(MAIN_PROGRAM, halos, tile),
                      execute_tiles_ref(MAIN_PROGRAM, halos, tile))
        ms, ms_lo, ms_hi = _time_ms(lambda: execute_tiles(MAIN_PROGRAM, halos, tile), 100)
        plain_ms, p_lo, p_hi = _time_ms(
            lambda: execute_tiles_ref(MAIN_PROGRAM, halos, tile), 10, warmup=2)
        bound_ms, bound_by = _stencil_bound(MAIN_PROGRAM, halos, tile)
        log(f"[timing] stencil_tiles {MAIN_PROGRAM} {label}: B={batch} halo "
            f"{tuple(halos.shape[1:])} float32: kernel {ms:.6f} ms (min "
            f"{ms_lo:.6f}, max {ms_hi:.6f}), plain {plain_ms:.6f} ms (min "
            f"{p_lo:.6f}, max {p_hi:.6f}), bound {bound_ms:.6f} ms "
            f"({bound_by}), {bound_ms / ms:.1%} of bound, max|kernel-plain| {err!r}")
        if err != 0.0:
            raise AssertionError(f"kernel differs from plain at {label}: {err!r}")
        rows.append({"label": label, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "err": err})
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"[timing] after timing: sm clock, max sm clock, power, temperature: {clocks}")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=MAIN_SPACE[0],
                    help="time steps of the main path's space (default %(default)s)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    # keep the autotuner's decision cache inside the checkout
    os.environ.setdefault("REPRO_AUTOTUNE_CACHE", str(ROOT / "build" / "autotune"))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    worst = phase_kernels(device)
    phase_small(device)
    main_run = phase_main(device, (args.steps, *MAIN_SPACE[1:]))
    rows = phase_timing(device, main_run)
    row = rows[0]
    kernels = [{
        "name": "stencil_tiles",
        "route": "cuda",
        "source": "src/repro_torch/kernels/stencil/csrc/stencil_tiles.cu",
        "replaces": "src/repro/kernels/stencil/stencil.py:50",
        "launches": main_run["launches"],
        "max_abs_err": max(worst, *(r["err"] for r in rows)),
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
    }]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
