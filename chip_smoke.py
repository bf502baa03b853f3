#!/usr/bin/env python3
"""Build the PyTorch port's CUDA kernels and drive its paths on one card.

    python3 chip_smoke.py            # needs one CUDA device and nvcc
    python3 chip_smoke.py --steps 64 # cut the time axis of every full-width path

Phases (each raises on failure; the script exits non-zero and prints no
result line unless every phase passed):

1.  device   — a CUDA device must exist; prints ``nvidia-smi``'s name and
               power limit;
2.  build    — compiles every kernel source from the checkout (one ``nvcc``
               per source, started together) and prints ptxas's register /
               shared-memory lines;
3.  kernels  — ``stencil_tiles`` against its plain PyTorch version on random
               inputs, every program of ``execute_tiles`` in float32 and
               float64; the difference must be 0 (bit-exact by design);
4.  fetch    — ``facet_fetch`` against its plain version on facets swept on
               the card (``jacobi2d5p``, ``jacobi2d9p``, ``gaussian``), both
               storages, float32 and float64; the difference must be 0, and
               the irredundant fetch over the deduplicated facets must equal
               the redundant fetch over the full ones;
5.  small    — ``repro_torch.cfa.compile(..., backend="cuda")`` on each 3-D
               program at test sizes: facets equal the card's ``sweep``
               backend exactly and the CPU's within float rounding;
6.  storage  — the same programs under ``storage="irredundant"`` (auto
               backend ``cuda``) and ``"compressed"`` (``deltapack16``, auto
               backend ``wavefront``): equal to ``sweep`` on the card bit for
               bit, to the CPU within rounding (compressed: within the
               codec's quantum); the ``raw`` codec's payload equals the
               irredundant one; codec words on the card equal the CPU's;
7.  main     — slice 1's path: ``cfa.compile("jacobi2d5p", (256, 1024,
               1024))`` with the autotuned layout and the auto backend
               (``cuda``), run once on seeded float32 inputs; kernel launches
               must equal the waves, facets must equal the card's
               ``reference`` backend;
8.  irredundant — slice 2's path at the same size: ``cfa.autotune(...,
               storage="irredundant")`` -> ``best_cfa(kernel_compatible=True)``
               -> ``cfa.compile(..., storage="irredundant")`` (auto backend
               ``cuda``) -> run -> ``fetch_interior_halos(...,
               storage="irredundant")`` over the payload.  Stencil launches
               must equal the waves and the fetch must launch once; the
               rehydrated payload must equal the redundant ``reference``
               backend at that layout bit for bit; the fetch must equal the
               redundant fetch over the rehydrated payload and the plain
               version, in float32 and float64, with difference 0;
9.  compressed — ``storage="compressed"`` (``deltapack16``) at (32, 1024,
               1024), autotuned, through its auto backend (``wavefront``):
               equal to ``sweep`` on the card bit for bit, finite, and its
               quantisation against the redundant reference reported;
10. timing   — each kernel timed with CUDA events at its path's shapes
               (median of 5 windows after warm-up launches), beside its plain
               version, its bound and, for the fetch, one ``torch.take``
               over a precomputed index as a bandwidth yardstick;
11. the ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

``--steps`` cuts the time axis of the full-width paths (7-9); by default
each runs at its full size.  Imports nothing of the JAX package; the port
is imported from ``src/`` beside this file.
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
#: the compressed path's space: the full grid, the time axis cut (it runs no
#: hand-written kernel and only holds the codec on the card)
COMPRESSED_SPACE = (32, 1024, 1024)
SMALL_CASES = [  # tests/test_passes.py's CASES, 3-D rows
    ("jacobi2d5p", (8, 8, 8), (4, 4, 4)),
    ("jacobi2d9p", (8, 8, 8), (4, 4, 4)),
    ("jacobi2d9p-gol", (8, 8, 8), (4, 4, 4)),
    ("gaussian", (4, 16, 16), (2, 8, 8)),
    ("smith-waterman-3seq", (9, 8, 8), (3, 4, 4)),
]
FETCH_CASES = [  # tests/test_kernels.py's facet-fetch cases
    ("jacobi2d5p", (8, 8, 8), (4, 4, 4)),
    ("jacobi2d9p", (12, 8, 8), (4, 4, 4)),
    ("gaussian", (4, 16, 16), (2, 8, 8)),
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


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same dtype, shape and bits (NaN-safe, -0.0 != 0.0)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def facets_equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(bit_equal(a[k], b[k]) for k in b)


def seeded_inputs(name: str, space, device, dtype=torch.float32) -> torch.Tensor:
    from repro_torch.core.cfa.programs import get_program

    w0 = get_program(name).widths[0]
    x = np.random.default_rng(SEED).normal(size=(w0, *space[1:]))
    return torch.as_tensor(x, dtype=dtype).to(device)


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
        x = seeded_inputs(name, space, "cpu", torch.float64)
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


def phase_fetch(device) -> float:
    """The read engine against its plain version on facets swept on the
    card, both storages, both dtypes."""
    from repro_torch import cfa
    from repro_torch.kernels.facet_fetch import fetch_interior_halos, fetch_interior_halos_ref

    worst = 0.0
    for name, space, tile in FETCH_CASES:
        compiled = cfa.compile(name, space, layout=tile, backend="cuda", device=device)
        smap = cfa.build_storage_map(compiled.pipeline.specs)
        for dtype in (torch.float32, torch.float64):
            facets = compiled(seeded_inputs(name, space, device), dtype=dtype)
            dd = cfa.dedup_facets(facets, smap)
            got = {}
            for storage, f in (("redundant", facets), ("irredundant", dd)):
                got[storage] = fetch_interior_halos(name, f, space, tile, storage=storage)
                want = fetch_interior_halos_ref(name, f, space, tile, storage=storage)
                torch.cuda.synchronize()
                err = max_abs(got[storage], want)
                log(f"[fetch] facet_fetch {name} @ {space} tile {tile} {storage} "
                    f"{str(dtype)[6:]} -> {tuple(want.shape)}: max|kernel-plain| = {err!r}")
                if not bit_equal(got[storage], want):
                    raise AssertionError(f"facet_fetch {name} {storage} {dtype}: differs "
                                         f"from its plain version by {err!r}")
                worst = max(worst, err)
            if not bit_equal(got["irredundant"], got["redundant"]):
                raise AssertionError(f"facet_fetch {name} {dtype}: the irredundant fetch "
                                     "differs from the redundant one")
    return worst


def phase_storage(device) -> None:
    """The storage disciplines through the front door at test sizes."""
    from repro_torch import cfa

    rng = np.random.default_rng(SEED)
    for name, codec in sorted(cfa.CODECS.items()):
        for dtype in (torch.float32, torch.float64):
            x = rng_tensor(rng, (7, 9, 5), dtype, "cpu")
            words_cpu, words_card = codec.encode(x), codec.encode(x.to(device))
            same = all(torch.equal(a, b.cpu()) for a, b in zip(words_cpu, words_card))
            same &= bit_equal(codec.roundtrip(x), codec.roundtrip(x.to(device)).cpu())
            if not same:
                raise AssertionError(f"codec {name} {dtype}: card and CPU words differ")
    log(f"[storage] codec words and round-trips on the card equal the CPU's: "
        f"{sorted(cfa.CODECS)} x float32/float64")
    for name, space, tile in SMALL_CASES:
        x = seeded_inputs(name, space, "cpu", torch.float64)
        payloads = {}
        for storage, want_backend in (("irredundant", "cuda"), ("compressed", "wavefront")):
            compiled = cfa.compile(name, space, layout=tile, storage=storage, device=device)
            if compiled.backend != want_backend:
                raise AssertionError(f"{name} {storage}: auto backend {compiled.backend!r}")
            for dtype in (torch.float32, torch.float64):
                got = compiled(x, dtype=dtype)
                ref = compiled.lower("sweep")(x, dtype=dtype)
                cpu = cfa.compile(name, space, layout=tile, backend="sweep", storage=storage,
                                  device="cpu")(x, dtype=dtype)
                torch.cuda.synchronize()
                exact = facets_equal(got, ref)
                err_cpu = max(max_abs(got[k].cpu(), cpu[k]) for k in cpu)
                # float rounding; compressed: deltapack16 keeps 16 high bits of
                # each XOR residual, so one ulp upstream may move a value by
                # the codec's quantum (2^-7 relative in float32)
                scale = max(1.0, max(float(v.abs().max()) for v in cpu.values()))
                tol = (2.0 ** -6 * scale if storage == "compressed" else
                       1e-5 if dtype == torch.float32 else 1e-12)
                log(f"[storage] {name} @ {space} tile {tile} {storage} "
                    f"({compiled.backend}) {str(dtype)[6:]}: ==sweep on card: {exact}, "
                    f"max|card-cpu| = {err_cpu!r}")
                if not exact or not err_cpu <= tol:
                    raise AssertionError(f"{name} {storage} {dtype}: disagrees")
                payloads[storage, dtype] = got
        raw = cfa.compile(name, space, layout=tile, storage="compressed", codec="raw",
                          device=device)(x, dtype=torch.float64)
        if not facets_equal(raw, payloads["irredundant", torch.float64]):
            raise AssertionError(f"{name}: the raw codec's payload is not the irredundant one")
    log("[storage] the raw codec's payload equals the irredundant payload on every program")


def phase_main(device, space=MAIN_SPACE) -> dict:
    """The full-size main path, once, through the front door."""
    from repro_torch import cfa
    from repro_torch.kernels.facet_fetch import fetch_interior_halos
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
    x = seeded_inputs(MAIN_PROGRAM, space, device)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    execute_tiles.launches = fetch_interior_halos.launches = 0
    t0 = time.perf_counter()
    facets = compiled(x, dtype=torch.float32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = execute_tiles.launches
    fetch_launches = fetch_interior_halos.launches
    peak = torch.cuda.max_memory_allocated()
    points = math.prod(space)
    log(f"[main] cuda backend: {wall:.3f} s wall (host clock around "
        f"synchronize), {points / wall:.4g} points/s, {launches} stencil_tiles "
        f"launches, {fetch_launches} facet_fetch launches, max_memory_allocated "
        f"{peak / 2**30:.3f} GiB")
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


def phase_irredundant(device, space=MAIN_SPACE) -> dict:
    """Slice 2's path, once, through the front door: irredundant storage
    and the read engine over its payload."""
    from repro_torch import cfa
    from repro_torch.kernels.facet_fetch import fetch_interior_halos, fetch_interior_halos_ref
    from repro_torch.kernels.stencil import execute_tiles

    t0 = time.perf_counter()
    decision = cfa.autotune(MAIN_PROGRAM, space, storage="irredundant")
    cand = decision.best_cfa(kernel_compatible=True).candidate
    compiled = cfa.compile(MAIN_PROGRAM, space, storage="irredundant", layout=cand,
                           device=device)
    t_compile = time.perf_counter() - t0
    pipe = compiled.pipeline
    waves = pipe.wavefronts()
    tile = pipe.tiling.sizes
    log(f"[irredundant] {compiled.describe()}")
    log(f"[irredundant] autotune + compile {t_compile:.2f} s; best kernel-compatible "
        f"layout {cand.key} (best overall {decision.best_cfa().candidate.key}), backend "
        f"{compiled.backend}, {math.prod(pipe.num_tiles)} tiles in {len(waves)} waves, "
        f"halo {tuple(w + t for w, t in zip(pipe.widths, tile))}, stored "
        f"{pipe.storage_map.stored_elems} of {pipe.storage_map.redundant_elems} slots")
    if compiled.backend != "cuda":
        raise AssertionError(f"auto backend is {compiled.backend!r}, not 'cuda'")
    x = seeded_inputs(MAIN_PROGRAM, space, device)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    execute_tiles.launches = fetch_interior_halos.launches = 0
    t0 = time.perf_counter()
    payload = compiled(x, dtype=torch.float32)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    halos = fetch_interior_halos(MAIN_PROGRAM, payload, space, tile, storage="irredundant")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"stencil_tiles": execute_tiles.launches,
                "facet_fetch": fetch_interior_halos.launches}
    peak = torch.cuda.max_memory_allocated()
    wall = t1 - t0
    log(f"[irredundant] cuda backend: {wall:.3f} s wall (host clock around "
        f"synchronize), {math.prod(space) / wall:.4g} points/s; fetch "
        f"{(t2 - t1) * 1e3:.3f} ms wall -> {tuple(halos.shape)}; launches {launches}; "
        f"max_memory_allocated {peak / 2**30:.3f} GiB")
    if launches["stencil_tiles"] != len(waves):
        raise AssertionError(f"{launches['stencil_tiles']} stencil launches for "
                             f"{len(waves)} waves")
    if launches["facet_fetch"] != 1:
        raise AssertionError(f"{launches['facet_fetch']} facet_fetch launches, not 1")

    t0 = time.perf_counter()
    ref = cfa.compile(MAIN_PROGRAM, space, layout=cand, backend="reference",
                      device=device)(x, dtype=torch.float32)
    rehydrated = compiled.rehydrate(payload)
    torch.cuda.synchronize()
    log(f"[irredundant] redundant reference backend + rehydrate {time.perf_counter() - t0:.3f} s")
    for k in ref:
        if not torch.isfinite(payload[k]).all():
            raise AssertionError(f"facet {k}: non-finite values")
        if not bit_equal(rehydrated[k], ref[k]):
            raise AssertionError(f"facet {k}: the rehydrated payload differs from the "
                                 f"redundant reference by {max_abs(rehydrated[k], ref[k])!r}")
    log("[irredundant] rehydrated payload == redundant reference backend, bit for bit, "
        "on every facet")
    del ref

    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        p = {k: v.to(dtype) for k, v in payload.items()}
        r = {k: v.to(dtype) for k, v in rehydrated.items()}
        got = halos if dtype == torch.float32 else fetch_interior_halos(
            MAIN_PROGRAM, p, space, tile, storage="irredundant")
        plain = fetch_interior_halos_ref(MAIN_PROGRAM, p, space, tile, storage="irredundant")
        err = max_abs(got, plain)
        ok = bit_equal(got, plain)
        del plain
        red = fetch_interior_halos(MAIN_PROGRAM, r, space, tile)
        torch.cuda.synchronize()
        err_red = max_abs(got, red)
        ok &= bit_equal(got, red) and bool(torch.isfinite(got).all())
        log(f"[irredundant] facet_fetch {str(dtype)[6:]} {tuple(got.shape)}: "
            f"max|kernel-plain| = {err!r}, max|irredundant-redundant(rehydrated)| = "
            f"{err_red!r}")
        if not ok:
            raise AssertionError(f"facet_fetch at full size {dtype}: differs")
        worst = max(worst, err, err_red)
        del p, r, got, red
    _host_split(compiled, payload, len(waves))
    return {"launches": launches, "payload": payload, "halos": halos, "tile": tile,
            "space": space, "err": worst, "largest_wave": max(len(w) for w in waves)}


def _host_split(compiled, payload: dict, n_waves: int, n: int = 64) -> None:
    """Where the irredundant path's time goes: ``n`` interior tiles of the
    run's own pipeline, each phase timed to a ``synchronize`` on a copy of
    the payload (copy_out commits in place): the static halo map, copy_in
    (map + index upload + gathers/scatter), copy_out (three owner-masked
    commits)."""
    pipe = compiled.pipeline
    facets = {k: v.clone() for k, v in payload.items()}
    nt = pipe.num_tiles
    tiles = [(1, 1, q) for q in range(max(1, min(100, nt[2] - n)), nt[2])[:n]]
    per = {"halo_map": 0.0, "copy_in": 0.0, "copy_out": 0.0}
    for tile in tiles:
        t0 = time.perf_counter()
        pipe._halo_maps(tile)
        t1 = time.perf_counter()
        H = pipe.copy_in(facets, tile)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pipe.copy_out(facets, tile, H)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        per["halo_map"] += t1 - t0
        per["copy_in"] += t2 - t1
        per["copy_out"] += t3 - t2
    n_tiles = math.prod(pipe.num_tiles)
    log(f"[irredundant] host split over {len(tiles)} interior tiles (each phase timed "
        f"to a synchronize): " + ", ".join(
            f"{k} {v / len(tiles) * 1e3:.3f} ms/tile (x {n_tiles} tiles = "
            f"{v / len(tiles) * n_tiles:.1f} s)" for k, v in per.items())
        + f"; copy_in includes halo_map; {n_waves} wave launches besides")


def phase_compressed(device, space=COMPRESSED_SPACE) -> None:
    """Compressed storage at full width through its auto backend."""
    from repro_torch import cfa

    t0 = time.perf_counter()
    decision = cfa.autotune(MAIN_PROGRAM, space, storage="compressed")
    cand = decision.best_cfa().candidate
    compiled = cfa.compile(MAIN_PROGRAM, space, storage="compressed", layout=cand,
                           device=device)
    t_compile = time.perf_counter() - t0
    pipe = compiled.pipeline
    log(f"[compressed] {compiled.describe()}")
    log(f"[compressed] autotune + compile {t_compile:.2f} s; layout {cand.key}, backend "
        f"{compiled.backend}, codec {compiled.codec.name}, "
        f"{math.prod(pipe.num_tiles)} tiles in {len(pipe.wavefronts())} waves")
    if compiled.backend != "wavefront":
        raise AssertionError(f"auto backend is {compiled.backend!r}, not 'wavefront'")
    x = seeded_inputs(MAIN_PROGRAM, space, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = compiled(x, dtype=torch.float32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    swept = compiled.lower("sweep")(x, dtype=torch.float32)
    torch.cuda.synchronize()
    t_sweep = time.perf_counter() - t0
    if not facets_equal(got, swept):
        raise AssertionError("compressed: wavefront differs from sweep on the card")
    if not all(torch.isfinite(v).all() for v in got.values()):
        raise AssertionError("compressed: non-finite values")
    ref = cfa.compile(MAIN_PROGRAM, space, layout=cand, backend="reference",
                      device=device)(x, dtype=torch.float32)
    rh = compiled.rehydrate(got)
    quant = {k: max_abs(rh[k], ref[k]) for k in ref}
    log(f"[compressed] wavefront {wall:.3f} s wall, {math.prod(space) / wall:.4g} points/s, "
        f"max_memory_allocated {peak / 2**30:.3f} GiB; sweep {t_sweep:.3f} s; "
        f"wavefront == sweep bit for bit; max|rehydrated - redundant reference| per "
        f"facet (the codec's quantisation) {quant}")


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


def phase_timing(device, main: dict, irr: dict) -> list[dict]:
    from repro_torch.kernels.stencil import execute_tiles, execute_tiles_ref

    rng = np.random.default_rng(SEED)
    w = main["widths"]
    shapes = [("main path (autotuned)", main["tile"], main["largest_wave"]),
              ("paper 64^3 tile", (64, 64, 64), main["largest_wave"]),
              ("irredundant path (autotuned)", irr["tile"], irr["largest_wave"])]
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
    return rows


def _fetch_index(payload: dict, space, tile) -> tuple[torch.Tensor, torch.Tensor]:
    """(flat, idx): the facets flattened and concatenated behind one zero
    element, and, for every element of the irredundant fetch's output, the
    position in ``flat`` of its source (0 for the tile interior) — built by
    running the plain version over index-valued facets."""
    from repro_torch.kernels.facet_fetch import fetch_interior_halos_ref

    ids, base = {}, 1
    for k in sorted(payload):
        n = payload[k].numel()
        ids[k] = torch.arange(base, base + n, dtype=torch.int64,
                              device=payload[k].device).reshape(payload[k].shape)
        base += n
    idx = fetch_interior_halos_ref(MAIN_PROGRAM, ids, space, tile, storage="irredundant")
    del ids
    flat = torch.cat([payload[0].new_zeros(1)] + [payload[k].reshape(-1) for k in sorted(payload)])
    return flat, idx


def phase_fetch_timing(run: dict) -> dict:
    """The read engine at the irredundant path's shapes, beside its plain
    version, its bytes bound and ``torch.take`` over a precomputed index."""
    from repro_torch.kernels.facet_fetch import fetch_interior_halos, fetch_interior_halos_ref

    payload, halos, space, tile = run["payload"], run["halos"], run["space"], run["tile"]
    flat, idx = _fetch_index(payload, space, tile)
    read = torch.unique(idx)
    n_read = read.numel() - int(read[0] == 0)  # distinct facet elements the fetch reads
    del read
    esize = halos.element_size()
    bound_ms = (n_read + halos.numel()) * esize / PEAK_BYTES_PER_S * 1e3
    take = torch.take(flat, idx)
    if not bit_equal(take, halos):
        raise AssertionError("torch.take over the precomputed index differs from the fetch")
    del take

    def kernel():
        return fetch_interior_halos(MAIN_PROGRAM, payload, space, tile, storage="irredundant")

    def plain():
        return fetch_interior_halos_ref(MAIN_PROGRAM, payload, space, tile, storage="irredundant")

    ms, ms_lo, ms_hi = _time_ms(kernel, 20, warmup=3)
    plain_ms, p_lo, p_hi = _time_ms(plain, 3, warmup=1)
    lib_ms, l_lo, l_hi = _time_ms(lambda: torch.take(flat, idx), 20, warmup=3)
    log(f"[timing] facet_fetch {MAIN_PROGRAM} irredundant {tuple(halos.shape)} "
        f"{str(halos.dtype)[6:]}: kernel {ms:.6f} ms (min {ms_lo:.6f}, max {ms_hi:.6f}), "
        f"plain {plain_ms:.6f} ms (min {p_lo:.6f}, max {p_hi:.6f}), torch.take over a "
        f"precomputed index (index and concatenation built outside the timed window) "
        f"{lib_ms:.6f} ms (min {l_lo:.6f}, max {l_hi:.6f}); bound {bound_ms:.6f} ms "
        f"(bytes: {n_read} distinct facet elements read + {halos.numel()} written, "
        f"{esize} B each, at 3.35 TB/s), {bound_ms / ms:.1%} of bound")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": "bytes"}


def log_clocks() -> None:
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"[timing] after timing: sm clock, max sm clock, power, temperature: {clocks}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=None,
                    help="time steps of the full-width paths (default: each path's "
                         f"full size, {MAIN_SPACE[0]} and {COMPRESSED_SPACE[0]})")
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

    def cut(space):
        return space if args.steps is None else (min(args.steps, space[0]), *space[1:])

    phase_device()
    phase_build()
    worst = phase_kernels(device)
    worst_fetch = phase_fetch(device)
    phase_small(device)
    phase_storage(device)
    main_run = phase_main(device, cut(MAIN_SPACE))
    irr_run = phase_irredundant(device, cut(MAIN_SPACE))
    phase_compressed(device, cut(COMPRESSED_SPACE))
    rows = phase_timing(device, main_run, irr_run)
    fetch_row = phase_fetch_timing(irr_run)
    log_clocks()
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
    }, {
        "name": "facet_fetch",
        "route": "cuda",
        "source": "src/repro_torch/kernels/facet_fetch/csrc/facet_fetch.cu",
        "replaces": "src/repro/kernels/facet_fetch/facet_fetch.py:106",
        "launches": irr_run["launches"]["facet_fetch"],
        "max_abs_err": max(worst_fetch, irr_run["err"]),
        **fetch_row,
    }]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
