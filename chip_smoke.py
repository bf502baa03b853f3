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
               shared-memory lines and the number of HMMA instructions in
               ``ssd_scan``'s and ``ssd_scan_bwd``'s SASS (``cuobjdump
               -sass``), each of which must be > 0;
3.  kernels  — ``stencil_tiles`` against its plain PyTorch version on random
               inputs, every program of ``execute_tiles`` in float32 and
               float64, by its launch plan and forced into every cluster of
               2..8 CTAs its tile splits into; the difference must be 0
               (bit-exact by design);
4.  fetch    — ``facet_fetch`` against its plain version on facets swept on
               the card (``jacobi2d5p``, ``jacobi2d9p``, ``gaussian``), both
               storages, float32 and float64; the difference must be 0, and
               the irredundant fetch over the deduplicated facets must equal
               the redundant fetch over the full ones; then on random facets
               at a shape whose bursts mix bulk copies and word loads and one
               whose bursts exceed shared memory (read in place); each line
               says how the bursts were copied;
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
8.  irredundant — slice 2's path at (64, 1024, 1024): ``cfa.autotune(...,
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
    kernels-sharded — ``execute_tiles_sharded`` (TPU kernel 1s: one
               ``stencil_tiles`` launch per port, each on its port's CUDA
               stream) against its plain version (``execute_tiles_ref`` per
               shard) and one launch over the whole batch, bit for bit: the
               kernel-check shapes at 2, 3 and 4 ports (padded), and
               ``[main]``'s full-size wave at 4 ports;
    sharded  — slice 4's multi-port path: ``cfa.compile(..., n_ports=4)``
               with ``[main]``'s layout (auto backend ``sharded``), run once
               with ``use_kernel=True``; every wave padded to 4 shards
               launches the kernel once per port (waves x 4 launches), and
               the facets equal ``[main]``'s bit for bit;
    dataflow — slice 4's overlapped path: ``cfa.compile(..., overlap=True)``
               (auto backend ``dataflow``), run once with ``use_kernel=True``
               (one launch per tile); facets equal ``[main]``'s; its wall
               beside ``[main]``'s is the overlap factor; a profiled run at
               a cut space counts the host's synchronising calls, the
               device overlap of the compute stream, and checks that the
               spans show prefetch and commit inside compute;
    fetch-sharded — ``fetch_interior_halos_sharded`` (TPU kernel 2s) over
               ``[irredundant]``'s payload placed on 4 ports: bit-equal to
               the plain version and to ``[irredundant]``'s fetch;
    distribute — ``compile(host_budget=2000)`` at (8, 8, 8) lowers to 2
               ports / ``sharded``; facets equal the ``reference`` backend;
    halo-quantize — ``compile(..., n_ports=2, halo_quantize=True)`` on the
               card equals the same call on the CPU bit for bit;
    calibrate — ``cfa.calibrate(H100_HBM3, device="cuda")`` over its default
               sweep (6 burst lengths x 3 counts of synthetic schedules, and
               ``jacobi2d5p`` and ``heat3d`` under the three storages at 1
               and 2 ports), then over ``PRESET_LENGTHS`` (the default
               lengths and bursts of 1, 8 and 64 MiB: the fit the committed
               preset copies): prints the samples, the noise, the committed
               preset's and the fitted ``setup_s``, ``peak_bytes_per_s`` and
               port factors, the worst plan error of each, every plan row
               and the card's name and power limit; the fitted parameters
               must be finite and positive, every plan row present and the
               record must survive its JSON round trip (no wall-clock
               threshold);
    h100-target — ``jacobi2d5p`` at (32, 1024, 1024) under the
               ``h100-hbm3`` target: ``cfa.autotune(..., score="measured",
               measure_top=3)`` on the card (its key beside ``axi-zc706``'s
               choice), ``cfa.compile(..., target="h100-hbm3", layout=<that
               decision>, verify=True)`` with no ERROR diagnostic, a run on
               the ``cuda`` backend (launches must equal the waves, facets
               must equal the ``reference`` backend bit for bit), the same
               run at ``axi-zc706``'s layout for its wall, then
               ``report(measured=True)`` and the top rows of
               ``runtime_report()``;
10. timing   — each kernel at its path's shapes (the stencil at the main
               wave, the paper's 64^3 tile, the irredundant wave and the
               dataflow path's single tile, each with its launch plan and
               a sweep over every cluster size the tile takes) on
               device time: ``iters``
               calls captured once in a CUDA graph and replayed between CUDA
               events, median of 5 windows (a call that cannot be captured
               is timed from the profiler's kernel rows, and its line says
               so), beside the host ms to issue one call and the eager
               back-to-back CUDA-event time; the plain version by eager
               CUDA events (some plain versions copy host scalars to the
               card, which a capture refuses); its bound and, for the fetch, one
               ``torch.take`` over a precomputed index as a bandwidth
               yardstick (timed like the kernel); the fetch's bursts (bulk
               or word); 1s over 4 port streams against one launch over the
               same wave (in turns), 2s against kernel 2;
11. attn-kernel — ``decode_attention`` against its plain version on
               ``tests/test_kernels.py``'s shapes, the partial final block,
               the decode shapes of jamba's SMOKE (B 4, Hq 4, Hkv 2, D 16,
               bs 16), olmoe-1b-7b (B 8, Hq = Hkv = 16, D 128: one query
               head per kv head), seamless-m4t-large-v2 (B 4, Hq = Hkv = 16,
               D 64, nb 3), llama-3.2-vision-11b (B 4, Hq 32, Hkv 8, D 128,
               nb 3) and qwen3-0.6b (B 8, Hq 16, Hkv 8, D 128,
               bs 256, nb 8; lengths 1, 256, 257, 2048, ...), for (q, K/V)
               in float32/float32, bfloat16/bfloat16 and float32/bfloat16
               (the model's float32-compute pairing); within 2e-5 + 2e-5 |want|
               for a float32 query and 1e-4 + 2^-7 |want| (one bfloat16
               rounding) for bfloat16, a limit that a control computed in
               bfloat16 throughout must exceed; then the wrapper as the
               model calls it (int64 lengths broadcast from one position):
               one kernel launch per call and nothing else on the card, no
               host synchronize or device-to-host copy (profiler), and a
               call captured in a CUDA graph equal to the eager one;
12. ssd-kernel — ``ssd_scan`` against its plain version on the test shapes,
               mamba2-370m's prefill shape (B 1 and 4, T 1024, H 32, P 64,
               N 128, chunk 128), jamba's SMOKE shape (chunk 8) and the
               serve stream's prompts shorter than
               a chunk (chunk = T), float32 and bfloat16; y within 1e-4 +
               1e-4 |want| and 1e-3 + 2^-7 |want| (the bfloat16 control
               must exceed it), the final state within 1e-4 + 1e-4 |want|;
               then the training route (``_SsdScan``'s launch, which also
               saves the state entering every chunk) on ``SSD_CASES`` and
               the training shape, both dtypes: y and the final state to the
               same limits, and every saved chunk state within 1e-4 + 1e-4
               |want| of ``ssd_chunked_ref``'s final state on the prefix
               before its chunk;
    ssd-bwd-kernel — slice 9's backward kernel ``ssd_scan_bwd`` (over the
               per-chunk states the forward saves) against its plain
               version, autograd through ``ssd_chunked_ref``, on
               ``SSD_CASES`` and the training shape (B 8, T 4096, H 32, P 64,
               N 128, chunk 128), float32 and bfloat16, with a zero and a
               seeded final-state gradient: float32 within 1e-4 max|want| +
               1e-6 per output (the sums run in another order; dB and dC sum
               over H P L terms); bfloat16 dx, dB and dC within one output
               rounding, 2^-7 |want| + 1e-3, which a bfloat16-throughout
               control must exceed, and dloga (float32) within the float32
               limit; two calls bit-equal (no atomics); at the training shape
               the gradient through ``ssd_scan`` (``_SsdScan``) and one call
               captured in a CUDA graph, each bit-equal to the direct call;
13. serve    — slices 3 and 8: for qwen3-0.6b, mamba2-370m and olmoe-1b-7b
               (64 experts, top-8, in each of its 16 layers) at ``tp=1``
               (the published widths and depth, random weights from
               ``torch.Generator("cuda").manual_seed(0)``) a
               ``ContinuousBatcher`` with 8 lanes and ``max_seq`` 2048
               answers 16 requests (prompt lengths seeded uniform in
               64..1024, 64 new tokens each).  Every request must finish with
               64 tokens, every logit must be finite, ``decode_attention``
               must launch once per attention layer per decode tick (28,
               0, 16) and ``ssd_scan`` once per Mamba layer per admitted
               prefill (0, 48, 0); then one request (prompt 128, 4
               decode steps) on the card against the same port on the CPU
               with the weights copied over (``CPU_CHECK``): relative max
               logit error below 1e-3 with float32 compute and caches at
               full depth (qwen3, mamba2) or a 2-layer cut (olmoe), and
               below 0.06 in the served bfloat16 at full depth (qwen3), cut
               to 4 layers (mamba2, whose 48 random layers amplify bf16
               rounding; the errors at 1-16 layers and full depth are
               printed) or to 2 (olmoe); tokens/s, ``stats()``, peak memory
               and a profiler window over decode ticks (kernel time only)
               are printed, and for olmoe the tick beside its dense-expert
               bound (every expert's weights read each tick, as the
               reference's dense dispatch does: 12.9 GB over 3.35 TB/s);
    serve-ctx — slice 8's context paths as a user runs them:
               ``repro_torch.launch.serve.main`` (``python -m
               repro_torch.launch.serve``) for llama-3.2-vision-11b (40
               layers, every 5th cross-attention to 1600 patch embeddings)
               and seamless-m4t-large-v2 (a 24-layer encoder over 4096
               frame embeddings, 24 decoder layers) at full width and depth,
               batch 4, prompt 512, 64 new tokens, seed 0:
               finite logits, the tokens' shape, ``decode_attention``
               launches = self-attention layers x 63 decode steps (32 x 63,
               24 x 63), no ``ssd_scan``; then the card-vs-CPU check (the
               limits above) on a full-width cut — one 5-layer period for
               the VLM, with its cross layer's gate at 0.5 so that the
               cross-attention reaches the logits; 2 encoder + 2 decoder
               layers for seamless — with the full context;
    jamba-smoke — jamba-1.5-large-398b's SMOKE config (attention, 7 Mamba
               layers, MoE on every other layer) through the batcher on the
               card in its served bfloat16, 8 requests on 4 lanes: every
               request finishes, ``decode_attention`` launches = ticks,
               ``ssd_scan`` = 7 x 8; each of its prefill and decode calls
               replayed on the CPU (weights copied, the card's tokens and
               expert choices fed) within 0.06; then the card-vs-CPU check
               on the whole SMOKE model (float32 within 1e-3, bf16 within
               0.06).  In every card-vs-CPU check of a model with experts
               the CPU runs the card's expert choices (top-k is
               discontinuous: at a near-tie one rounding picks another
               expert); its own choices may differ in float32 only where
               the k-th and (k+1)-th router probabilities are within
               ``ROUTE_TIE_F32`` (1e-5) on both devices, and in bfloat16
               the differing choices are printed with their margins;
14. serve timing — both kernels timed as in phase 10 at their path
               shapes, beside their plain versions, their bounds and, for
               ``decode_attention``, ``scaled_dot_product_attention`` over
               the deblockified cache with the same mask as a yardstick;
               the attention's launch plan at the tick (CTAs, working CTAs,
               shared memory per CTA); ``ssd_scan``'s launch plan at B 1 and
               4, its bound on the tensor-core route beside the FP32-pipe
               figure, and one call captured in a CUDA graph, which must
               equal the eager call bit for bit;
    train    — slice 9: mamba2-370m at full width and depth (48 layers,
               d_model 1024, 32 heads x 64, state 128, chunk 128, vocab
               50280) trains on the card, AdamW, remat, float32 master
               weights, bfloat16 compute, seq 4096 at the largest batch of
               8, 4, 2 that fits: ``repro_torch.launch.train.main`` for 4
               steps into a checkpoint directory (as ``python -m
               repro_torch.launch.train`` runs), then the same command
               again, which must resume at step 4 and run steps 5-8;
               ``ssd_scan`` must launch 48 x 2 x 8 times (forward and remat
               recompute) and ``ssd_scan_bwd`` 48 x 8; every loss and
               grad-norm finite; step 4's checkpoint read back and a
               restart's restore of step 8 bit-equal to the saved state; an
               uninterrupted 8-step ``Trainer`` run from the same seed must
               give the resumed run's losses at steps 5-8 (bit-equal, or
               within 1e-5 relative); a fixed batch's step-8 loss below its
               step-1 loss; printed: median step ms, tokens/s, peak memory,
               the device's busy share over a profiled step and the model
               FLOPs (8 N tokens with remat) against 989 TFLOP/s; then card
               vs CPU gradients on a full-width 2-layer cut (batch 1, seq
               512, float32 compute, weights copied): every leaf within
               1e-3 max|g_cpu| + 1e-6, the loss within 1e-4 relative;
    train-mesh — slice 11: the training path on a world-1 ``DeviceMesh``
               (an ``nccl`` group in this process over a ``FileStore``
               under ``build/``): ``Trainer(mesh=mesh_for_devices())`` on
               mamba2-370m at ``[train]``'s batch x 4096 for 2 steps
               (parameters and moments DTensors, each weight gathered where
               a layer reads it, gradients reduce-scattered), then an
               unmeshed ``Trainer`` for 2 steps: losses, grad norms,
               parameters and moments bit-equal; ``ssd_scan`` 48 x 2 x 2
               and ``ssd_scan_bwd`` 48 x 2 launches in the meshed run; the
               meshed checkpoint restored with ``shardings=`` bit-equal;
               one profiled meshed step (device busy share, the
               collectives' device time and host calls); then ``python -m
               torch.distributed.run --standalone --nproc-per-node 1 -m
               repro_torch.launch.train`` as a child, whose losses must
               equal the meshed run's; printed: both runs' step ms and
               peak memory, beside the card's name and power limit;
    pipeline — slice 12's GPipe: ``pipeline_apply`` in ``python -m
               torch.distributed.run --nproc-per-node 4`` as a child, 4 gloo
               ranks on the one card (NCCL refuses two ranks on one GPU;
               gloo sends CPU tensors only, so each tick's activations are
               staged through the host), each rank one deepseek-67b block at
               the published widths (d_model 8192, 64 heads, 8 KV heads,
               d_ff 22016, bf16; depth cut to 4 of 95 layers) held as
               DTensors ``Shard(0)`` over ``pipe``, 8 microbatches of 1 x
               2048 tokens through the port's block forward in training
               mode: the output the same on every rank and equal, bit for
               bit, to a sequential run of the same blocks in this process;
               printed: both walls, the bubble 3/11 and the bytes staged per
               tick;
    tools    — slice 12's CLIs through the ``main`` that ``python -m
               repro_torch.tools.<name>`` runs: ``cfa_trace --validate`` on
               the kernel backend (launches = waves) and the dataflow
               backend, ``cfa_lint --json --include-baselines`` on the card
               equal to ``--device cpu``, ``dump_pipeline --verify`` (2
               ports, ``sharded``), and ``stencil_tile_op`` with the kernel
               against its plain version on ``KERNEL_CASES``: difference 0,
               one launch per call;
    dryrun   — ``python -m repro_torch.launch.dryrun`` for ``DRYRUN_CELLS``
               (qwen3-0.6b train_4k on 256 fake ranks, jamba-1.5-large-398b
               long_500k on 512), children started before ``[pipeline]``
               with no CUDA device visible: each must exit 0 with an ``ok``
               record (FLOPs, per-rank bytes and collectives printed);
    examples — slice 13's ``python -m repro_torch.examples.<name>``, each a
               child with no ``--device`` (so on the card), exit 0 and ``OK``
               last, after ``[dryrun]``'s children are collected:
               ``quickstart`` and ``stencil_pipeline`` (``stencil_tiles``
               launches = waves, ``cuda`` == ``sweep`` / ``wavefront`` bit for
               bit), ``serve_decode`` (``decode_attention`` launches = the
               SMOKE config's attention layers x decode steps) and
               ``pipeline_parallel`` (4 gloo ranks on the card, err < 1e-5,
               bubble 3/11) side by side, beside ``train_lm --steps
               EXAMPLES_TRAIN_STEPS`` (``CFG_100M``, batch 4 x 256) stopped by
               its ``PREEMPT`` sentinel after its step-50 checkpoint and rerun
               with the same command; then the uninterrupted run alone
               (``train_lm.run`` in this process): the logged losses it shares
               with the other two runs and their last common checkpoint
               bit-equal; printed: ms/step, tokens/s, peak memory; then one
               profiled ``CFG_100M`` step (device busy share, model FLOPs) and
               card vs CPU gradients on its 2-layer cut (batch 1, seq 256,
               float32 compute): every leaf within 1e-3 max|g_cpu| + 1e-6, the
               loss within 1e-4 relative — dense attention's backward on the
               card;
    train timing — ``ssd_scan_bwd`` at the training shape and the serve
               shape (B 1, T 1024) in bfloat16 by graph replay, beside its
               plain version, the forward at the same shape, its bytes
               bound and its FP32-pipe figure (no single PyTorch call
               computes the SSD's gradient: no library yardstick), and each
               of its four launches' device time by kernel name from one
               profiled call;
15. the ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

The phases run in the order device, build, kernels, fetch, small, storage,
attn-kernel, ssd-kernel, ssd-bwd-kernel, main, kernels-sharded, sharded,
dataflow, irredundant, fetch-sharded, compressed, distribute,
halo-quantize, calibrate, h100-target, serve, serve-ctx, jamba-smoke,
train, train-mesh, pipeline and tools (with dryrun's children beside
them), examples, timing (stencil, fetch, 1s/2s), serve timing, train timing; each
model is freed before the next (olmoe holds 13.8 GB, the VLM 20.2 GB, the
training run about 37 GiB at its peak): every profiler window that reads
host calls and kernels together runs before the timing phases'
kernel-only windows and graph captures.
``--steps`` cuts the time axis of the full-width stencil paths; by
default each runs at its full size.  Imports nothing of the JAX package;
the port is imported from ``src/`` beside this file.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
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
#: dense bf16 on the tensor cores (the same data sheet)
PEAK_BF16_TC_FLOPS = 989e12
MAIN_PROGRAM = "jacobi2d5p"
MAIN_SPACE = (256, 1024, 1024)
#: the compressed path's space: the full grid, the time axis cut (it runs no
#: hand-written kernel and only holds the codec on the card)
COMPRESSED_SPACE = (32, 1024, 1024)
#: the irredundant path's space: the full grid, the time axis cut from 256 so
#: that the whole script stays within half its time limit on a slow host (its
#: host-bound copy_in took about a fifth of the run at 256 steps)
IRREDUNDANT_SPACE = (64, 1024, 1024)
#: the h100-target path's space: the main path's widths, the time axis cut
H100_SPACE = (32, 1024, 1024)
#: the burst lengths of the sweep the H100_HBM3 preset is fitted from: the
#: default sweep's (up to 32768 elements, 128 KiB: its byte term is far below
#: one launch) and bursts of 1, 8 and 64 MiB, whose copy time the host clock
#: resolves
PRESET_LENGTHS = (1, 8, 64, 512, 4096, 32768, 262144, 2097152, 16777216)
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
#: the read engine's other two routes, on seeded random facets: bursts that are
#: not 16-byte multiples (word loads beside bulk copies), and a tile whose
#: bursts exceed shared memory (read in place)
FETCH_EDGE_CASES = [
    ("smith-waterman-3seq", (9, 8, 8), (3, 4, 4)),
    ("jacobi2d5p", (128, 1024, 16), (64, 512, 8)),
]
ATTN_CASES = [  # B, Hq, Hkv, D, S, bs, lengths (None: seeded in 1..S)
    (2, 8, 2, 64, 256, 64, None),  # tests/test_kernels.py's cases
    (1, 4, 4, 32, 128, 32, None),
    (3, 16, 1, 64, 192, 64, None),
    (2, 4, 2, 32, 128, 32, [1, 33]),  # the partial final block
    (4, 4, 2, 16, 128, 16, [1, 17, 96, 128]),  # jamba's SMOKE through the batcher
    (8, 16, 16, 128, 2048, 256, [1, 256, 257, 2048, 64, 777, 1024, 1500]),  # olmoe-1b-7b: G 1
    (4, 16, 16, 64, 768, 256, [513, 576, 600, 1]),  # seamless-m4t-large-v2: G 1, D 64
    (4, 32, 8, 128, 768, 256, [513, 576, 540, 1]),  # llama-3.2-vision-11b: G 4
    (8, 16, 8, 128, 2048, 256, [1, 256, 257, 2048, 64, 777, 1024, 1500]),  # qwen3-0.6b (last)
]
SSD_CASES = [  # B, T, H, P, N, chunk; phase 12 adds the serve stream's short prompts
    (2, 64, 4, 16, 8, 16), (1, 128, 2, 32, 16, 32), (2, 96, 8, 8, 4, 32),  # the tests'
    (1, 1024, 32, 64, 128, 128), (4, 1024, 32, 64, 128, 128),  # mamba2-370m
    (1, 256, 2, 64, 256, 128),  # the largest state: one staging stage
    (1, 64, 8, 16, 16, 8),  # jamba's SMOKE: chunk 8
]
#: kernel-vs-plain limits, (rtol, atol): |got - want| <= atol + rtol |want|.  A
#: bfloat16 output may round the other way from the plain version's, one unit
#: in the last place, which is at most 2^-7 |want|; the atol covers values near 0
ATTN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2.0 ** -7, 1e-4)}
SSD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-3)}
STATE_TOL = (1e-4, 1e-4)
#: the backward's limits: float32, |got - want| <= 1e-4 max|want| + 1e-6 per
#: output (the sums run in another order; dB and dC sum over H P L terms);
#: bfloat16 dx, dB and dC within one output rounding of the plain version
#: (its float32 gradient rounded), dloga (float32 out) within the float32 limit
SSD_BWD_F32 = (1e-4, 1e-6)
SSD_BWD_BF16 = (2.0 ** -7, 1e-3)
#: slice 9's training path: mamba2-370m at full width and depth, the
#: train_4k cell's sequence, the largest batch of these that fits one card
TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCHES, TRAIN_STEPS = "mamba2-370m", 4096, (8, 4, 2), 4
#: mamba2-370m's SSD at the training shape (B, T, H, P, N, chunk)
SSD_TRAIN_SHAPE = (8, 4096, 32, 64, 128, 128)
#: the card-vs-CPU gradient check: a full-width cut, float32 compute
TRAIN_CPU_LAYERS, TRAIN_CPU_SEQ = 2, 512
TRAIN_GRAD_TOL = (1e-3, 1e-6)  # per leaf: 1e-3 max|g_cpu| + 1e-6; the loss within 1e-4
#: [examples]: train_lm's steps (cut from the example's 300 for the script's
#: time; 120 leaves a common checkpoint, step 100, after a stop past step 50),
#: its checkpoint interval (fixed in the example), and the card-vs-CPU
#: gradient cut of CFG_100M
EXAMPLES_TRAIN_STEPS, EXAMPLES_CKPT_EVERY = 120, 50
EXAMPLES_CPU_LAYERS, EXAMPLES_CPU_SEQ = 2, 256
#: steps of each [train-mesh] run (meshed, unmeshed, the torchrun launcher)
TRAIN_MESH_STEPS = 2
#: slice 12's pipeline: deepseek-67b blocks at the published widths (d_model
#: 8192, 64 heads, 8 KV heads, d_ff 22016, bf16), one per stage, depth cut
#: from 95 to PIPE_STAGES layers; PIPE_MICRO microbatches of 1 x PIPE_SEQ tokens
PIPE_ARCH, PIPE_STAGES, PIPE_MICRO, PIPE_SEQ = "deepseek-67b", 4, 8, 2048
#: [tools]' cfa_trace runs: jacobi2d5p on the kernel backend (``cuda``: one
#: launch per wave) at TOOLS_SPACE and on the dataflow backend (the CLI
#: passes no ``use_kernel``, so each tile runs the plain version on the card)
#: at TOOLS_DATAFLOW_SPACE, both with TOOLS_TILE.  A traced run's per-tile
#: accounting (``spaces.flow_in_points``, a numpy ``unique`` over the tile's
#: points, as in the reference) costs about 20 us per point on the host
#: (627 s at (128, 512, 512) on the card machine), so the spaces are small
TOOLS_SPACE, TOOLS_DATAFLOW_SPACE, TOOLS_TILE = (32, 128, 128), (16, 64, 64), (8, 32, 32)
#: [dryrun]'s cells (python -m repro_torch.launch.dryrun), full configurations
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k", "single"),
                ("jamba-1.5-large-398b", "long_500k", "multi"))
SERVE_ARCHS = ("qwen3-0.6b", "mamba2-370m", "olmoe-1b-7b")
SERVE_LANES, SERVE_MAX_SEQ, SERVE_REQUESTS, SERVE_MAX_NEW = 8, 2048, 16, 64
SERVE_PROMPTS = (64, 1024)  # prompt lengths, seeded uniform, inclusive
#: the launcher's paths (python -m repro_torch.launch.serve), at full width
#: and depth: the VLM and the encoder-decoder take context embeddings
CTX_ARCHS = ("llama-3.2-vision-11b", "seamless-m4t-large-v2")
CTX_BATCH, CTX_PROMPT, CTX_GEN = 4, 512, 64
CPU_CHECK_PROMPT, CPU_CHECK_STEPS = 128, 4
#: the card-vs-CPU check per model: (depths at which the served bfloat16 run
#: is held to the CPU and printed, the depth whose bf16 error is checked, the
#: depth of the float32 check).  mamba2-370m's 48 random layers amplify bf16
#: rounding (its CPU logits move 0.14-0.27 between bf16 and f32 compute), so
#: its bf16 witness is a depth cut; the later models are checked at a
#: full-width cut (olmoe: 2 of 16 layers; vision: one 5-layer period of 8;
#: seamless: 2 encoder and 2 decoder layers of 24 each) — on the host CPU a
#: full-depth float32 copy would be 28-40 GB of weights
CPU_CHECK = {
    "qwen3-0.6b": ((1, 2, 4, 8, 16, 28), 28, 28),
    "mamba2-370m": ((1, 2, 4, 8, 16, 48), 4, 48),
    "olmoe-1b-7b": ((2,), 2, 2),
    "llama-3.2-vision-11b": ((5,), 5, 5),
    "seamless-m4t-large-v2": ((2,), 2, 2),
    "jamba-1.5-large-398b": ((8,), 8, 8),  # its SMOKE config, whole
}
#: an MoE router's top-k choice is discontinuous: where its k-th and (k+1)-th
#: probabilities nearly tie, one rounding of the hidden state picks another
#: expert and moves that token's output by O(1).  So the card-vs-CPU check
#: runs the CPU with the card's expert choices (its own probabilities at
#: them) and holds the logits to their limits.  The CPU's own choices are
#: recorded beside the card's: in float32 every token whose expert set
#: differs must be a near-tie, the two probabilities within ROUTE_TIE_F32 on
#: both devices (float32 rounding moves them by ~1e-7); in bfloat16 the
#: router's input is rounded to 8 bits, the two devices' probabilities
#: differ by some delta and any pair within 2 delta may swap: those flips
#: are printed with their margins and deltas, not limited
ROUTE_TIE_F32 = 1e-5
#: the cross layers' gate in the card-vs-CPU check of the VLM (its init is 0,
#: which would hide the cross-attention's output from the logits)
CHECK_GATE = 0.5
BF16_LOGIT_TOL = 0.06  # tests/test_archs.py's relative max error
#: jamba's SMOKE config (attention, Mamba and MoE in one model) through the
#: batcher in its served bfloat16, card against the same calls on the CPU
JAMBA = "jamba-1.5-large-398b"
JAMBA_LANES, JAMBA_MAX_SEQ, JAMBA_REQUESTS, JAMBA_MAX_NEW = 4, 128, 8, 16
JAMBA_PROMPTS = (8, 96)
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
    return torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


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
    # the SSD's bf16 chunk products, forward and backward, run on the tensor
    # cores: HMMA in their SASS
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    for name in ("ssd_scan", "ssd_scan_bwd"):
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build._library_path(name))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        hmma = sum(1 for line in sass.splitlines() if "HMMA" in line)
        log(f"[build] {name}: {hmma} HMMA instructions in its SASS ({cuobjdump} -sass)")
        if hmma == 0:
            raise AssertionError(f"{name}'s SASS holds no HMMA: its products are not on the "
                                 f"tensor cores")


def phase_kernels(device) -> float:
    """Every program, both dtypes: the kernel against its plain version, by
    its launch plan and by every cluster the tile splits into."""
    from repro_torch.core.cfa.programs import get_program
    from repro_torch.kernels.stencil import execute_tiles, execute_tiles_ref
    from repro_torch.kernels.stencil import stencil

    rng = np.random.default_rng(SEED)
    worst = 0.0
    for name, tile, batch in KERNEL_CASES:
        w = get_program(name).widths
        shape = (batch, *(wa + ta for wa, ta in zip(w, tile)))
        for dtype in (torch.float32, torch.float64):
            halos = rng_tensor(rng, shape, dtype, device)
            got = execute_tiles(name, halos, tile)
            want = execute_tiles_ref(name, halos, tile)
            # every split of the tile into a cluster (these shapes plan one CTA)
            forced = {}
            for k in range(2, stencil.MAX_CLUSTER + 1):
                try:
                    plan = stencil.launch_plan(name, batch, tile, dtype, k=k)
                except ValueError:
                    continue
                out = torch.empty_like(want)
                stencil._launch(stencil._check(name, halos, tile, out), halos, out, plan)
                forced[k] = out
            torch.cuda.synchronize()
            err = max_abs(got, want)
            errs = {k: max_abs(out, want) for k, out in forced.items()}
            log(f"[kernels] stencil_tiles {name} tile={tile} B={batch} "
                f"{str(dtype)[6:]}: max|kernel-plain| = {err!r} (planned "
                f"k={stencil.launch_plan(name, batch, tile, dtype).k}); forced clusters "
                f"k: max|kernel-plain| {errs}")
            if not (torch.isfinite(got).all() and err == 0.0
                    and all(bit_equal(out, want) for out in forced.values())):
                raise AssertionError(f"stencil_tiles {name} {dtype}: differs "
                                     f"from its plain version by {err!r}, forced {errs}")
            worst = max(worst, err, *errs.values())
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


def _bursts(name: str, facets: dict, space, tile, storage: str) -> str:
    """How the read engine copies a call's bursts: bursts per tile, how many
    (over all tiles) take one bulk copy and how many word loads, and the
    bytes a CTA stages."""
    from repro_torch.kernels.facet_fetch.facet_fetch import burst_paths, fetch_geometry

    b = burst_paths(fetch_geometry(name, facets, space, tile, storage), facets, storage)
    return (f"{b['bursts_per_tile']} bursts/tile x {b['tiles']} tiles: {b['bulk']} bulk, "
            f"{b['word']} word, {b['staged_bytes']} B staged per CTA")


def phase_fetch(device) -> float:
    """The read engine against its plain version on facets swept on the
    card, both storages, both dtypes."""
    from repro_torch import cfa
    from repro_torch.core.cfa import CFAPipeline, IterSpace, Tiling, get_program
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
                    f"{str(dtype)[6:]} -> {tuple(want.shape)}: max|kernel-plain| = {err!r}; "
                    f"{_bursts(name, f, space, tile, storage)}")
                if not bit_equal(got[storage], want):
                    raise AssertionError(f"facet_fetch {name} {storage} {dtype}: differs "
                                         f"from its plain version by {err!r}")
                worst = max(worst, err)
            if not bit_equal(got["irredundant"], got["redundant"]):
                raise AssertionError(f"facet_fetch {name} {dtype}: the irredundant fetch "
                                     "differs from the redundant one")
    gen = torch.Generator(device).manual_seed(SEED)
    for name, space, tile in FETCH_EDGE_CASES:
        pipe = CFAPipeline(get_program(name), IterSpace(space), Tiling(tile), device="cpu")
        for dtype in (torch.float32, torch.float64):
            f = {k: torch.randn(pipe.facet_shape(k), generator=gen, device=device, dtype=dtype)
                 for k in pipe.specs}
            for storage in ("redundant", "irredundant"):
                got = fetch_interior_halos(name, f, space, tile, storage=storage)
                want = fetch_interior_halos_ref(name, f, space, tile, storage=storage)
                torch.cuda.synchronize()
                err = max_abs(got, want)
                log(f"[fetch] facet_fetch {name} @ {space} tile {tile} {storage} "
                    f"{str(dtype)[6:]}, random facets -> {tuple(want.shape)}: max|kernel-plain| "
                    f"= {err!r}; {_bursts(name, f, space, tile, storage)}")
                if not bit_equal(got, want):
                    raise AssertionError(f"facet_fetch {name} {storage} {dtype}: differs "
                                         f"from its plain version by {err!r}")
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
            "widths": compiled.program.widths, "largest_wave": max(len(w) for w in waves),
            "facets": facets, "wall": wall, "layout": compiled.layout, "space": space,
            "waves": len(waves)}


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
            f"{err_red!r}; irredundant {_bursts(MAIN_PROGRAM, p, space, tile, 'irredundant')}; "
            f"redundant {_bursts(MAIN_PROGRAM, r, space, tile, 'redundant')}")
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
    ``iters`` back-to-back eager calls each, after ``warmup`` calls.  When the
    host takes longer to issue a call than the card takes to run it, this
    measures the host: kernel rows use :func:`_device_ms` instead."""
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


def _device_ms(fn, iters: int, repeats: int = 5) -> tuple[float, float, float, str]:
    """(median, min, max, method): device ms per call.  ``iters`` calls are
    captured once in a CUDA graph (after warm-up calls on the caller's and
    on a side stream) and the graph is replayed between two CUDA events,
    ``repeats`` windows: the card runs the calls back to back whatever the
    host's speed.  A call that cannot be captured is timed from the
    profiler's kernel rows instead (method ``"profiler"``: the sum of its
    kernels' device time, one window)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
    except RuntimeError as e:
        torch.cuda.synchronize()
        ms = _profiler_ms(fn, iters)
        return ms, ms, ms, f"profiler (capture failed: {str(e).splitlines()[0][:80]})"
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    per_call = []
    for _ in range(repeats):
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        per_call.append(start.elapsed_time(stop) / iters)
    del graph
    return statistics.median(per_call), min(per_call), max(per_call), "graph"


def _profiler_ms(fn, iters: int) -> float:
    """Device ms per call: the kernel rows of ``torch.profiler`` over
    ``iters`` eager calls, summed (busy time; gaps between kernels excluded):
    the fallback of :func:`_device_ms` for a call that cannot be captured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0)
    return us / iters / 1e3


def _host_ms(fn, iters: int) -> float:
    """Host milliseconds to enqueue one call of ``fn`` (``iters`` calls after a
    synchronize, none waited on): beside a device time it tells a
    host-bound call from a device-bound one."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return t


def _measure(fn, iters: int) -> dict:
    """A kernel's or library call's row: device ms (graph replay; min, max,
    method), host ms to issue one call, and the eager back-to-back CUDA-event
    time (what the timing lines reported before device time was read)."""
    ms, lo, hi, method = _device_ms(fn, iters)
    return {"ms": ms, "lo": lo, "hi": hi, "method": method, "host_ms": _host_ms(fn, iters),
            "events_ms": _time_ms(fn, iters, warmup=3)[0]}


def _fmt(m: dict) -> str:
    return (f"{m['ms']:.6f} ms device (min {m['lo']:.6f}, max {m['hi']:.6f}; {m['method']}), "
            f"host {m['host_ms']:.6f} ms per call, eager events {m['events_ms']:.6f} ms")


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
    from repro_torch.kernels.stencil import execute_tiles, execute_tiles_ref, launch_plan
    from repro_torch.kernels.stencil import stencil
    from repro_torch.kernels.stencil.stencil import THREADS as stencil_threads

    rng = np.random.default_rng(SEED)
    w = main["widths"]
    shapes = [("main path (autotuned)", main["tile"], main["largest_wave"]),
              ("paper 64^3 tile", (64, 64, 64), main["largest_wave"]),
              ("irredundant path (autotuned)", irr["tile"], irr["largest_wave"]),
              ("dataflow path, one tile per launch", main["tile"], 1)]
    rows = []
    for label, tile, batch in shapes:
        plan = launch_plan(MAIN_PROGRAM, batch, tile, torch.float32)
        log(f"[timing] stencil_tiles launch plan at {label}, B={batch} tile {tuple(tile)}: "
            f"split axis {plan.split} into k={plan.k} strips of {plan.strip} rows (cluster "
            f"{plan.k}), {plan.ctas} CTAs of {stencil_threads} threads, a ring of "
            f"{plan.ring} planes of {plan.slot} ({plan.ahead} loaded ahead), {plan.smem} B "
            f"of shared memory per CTA ({plan.halo_parts} halo-part elements), "
            f"{plan.ctas_per_sm} CTAs per SM")
        halos = rng_tensor(rng, (batch, *(wa + ta for wa, ta in zip(w, tile))),
                           torch.float32, device)
        want = execute_tiles_ref(MAIN_PROGRAM, halos, tile)
        err = max_abs(execute_tiles(MAIN_PROGRAM, halos, tile), want)
        m = _measure(lambda: execute_tiles(MAIN_PROGRAM, halos, tile), 100)
        plain_ms = _time_ms(lambda: execute_tiles_ref(MAIN_PROGRAM, halos, tile), 10, warmup=2)[0]
        bound_ms, bound_by = _stencil_bound(MAIN_PROGRAM, halos, tile)
        log(f"[timing] stencil_tiles {MAIN_PROGRAM} {label}: B={batch} halo "
            f"{tuple(halos.shape[1:])} float32: kernel {_fmt(m)}; plain {plain_ms:.6f} ms "
            f"(eager CUDA events); bound {bound_ms:.6f} ms ({bound_by}), "
            f"{bound_ms / m['ms']:.1%} of bound; max|kernel-plain| {err!r}")
        if err != 0.0:
            raise AssertionError(f"kernel differs from plain at {label}: {err!r}")
        rows.append({"label": label, "ms": m["ms"], "host_ms": m["host_ms"],
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "err": err, "batch": batch, "tile": tuple(tile)})
        # the split sweep: every cluster size the tile takes, timed alike
        out, sweep = torch.empty_like(want), []
        call = stencil._check(MAIN_PROGRAM, halos, tile, out)
        for k in range(1, stencil.MAX_CLUSTER + 1):
            try:
                kplan = launch_plan(MAIN_PROGRAM, batch, tile, torch.float32, k=k)
            except ValueError:
                continue
            ms = _device_ms(lambda: stencil._launch(call, halos, out, kplan), 50)[0]
            sweep.append(f"k={k} {ms:.6f}")
            if not bit_equal(out, want):
                raise AssertionError(f"stencil_tiles at {label} with k={k} differs from plain")
        log(f"[timing] stencil_tiles split sweep at {label} (device ms, graph): "
            f"{', '.join(sweep)}; planned k={plan.k}")
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
    from repro_torch.kernels.facet_fetch.facet_fetch import burst_paths, fetch_geometry

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

    m = _measure(kernel, 20)
    plain_ms = _time_ms(plain, 3, warmup=1)[0]
    lib = _measure(lambda: torch.take(flat, idx), 20)
    paths = burst_paths(fetch_geometry(MAIN_PROGRAM, payload, space, tile, "irredundant"),
                        payload, "irredundant")
    log(f"[timing] facet_fetch {MAIN_PROGRAM} irredundant {tuple(halos.shape)} "
        f"{str(halos.dtype)[6:]}: kernel {_fmt(m)}; plain {plain_ms:.6f} ms (eager CUDA "
        f"events); torch.take over a precomputed index (index and concatenation built outside "
        f"the timed window) {_fmt(lib)}; bound {bound_ms:.6f} ms (bytes: {n_read} distinct "
        f"facet elements read + {halos.numel()} written, {esize} B each, at 3.35 TB/s), "
        f"{bound_ms / m['ms']:.1%} of bound; bursts {paths}")
    return {"ms": m["ms"], "host_ms": m["host_ms"], "plain_ms": plain_ms, "library_ms": lib["ms"],
            "bound_ms": bound_ms, "bound_by": "bytes"}


# -- slice 4: the multi-port (sharded) and overlapped (dataflow) paths -------------


def _pad(halos: torch.Tensor, n: int) -> torch.Tensor:
    """The batch padded to a multiple of ``n`` by repeating it, as the
    sharded sweep pads a wave."""
    target = -(-halos.shape[0] // n) * n
    return torch.cat([halos] * -(-target // halos.shape[0]))[:target]


def _sharded_plain(name: str, halos: torch.Tensor, tile, n: int) -> torch.Tensor:
    """1s's plain version: ``execute_tiles_ref`` per port shard, in order."""
    from repro_torch.kernels.stencil import execute_tiles_ref

    m = halos.shape[0] // n
    return torch.cat([execute_tiles_ref(name, halos[p * m:(p + 1) * m], tile)
                      for p in range(n)])


def phase_kernels_sharded(device, main: dict) -> float:
    """``execute_tiles_sharded`` (one launch per port, each on its port's
    stream) against its plain version and one ``execute_tiles`` launch over
    the whole batch: the kernel-check shapes at 2, 3 and 4 ports (batches
    padded), and the main path's full-size wave at 4 ports; difference 0."""
    from repro_torch.core.cfa.programs import get_program
    from repro_torch.distributed.sharding import port_mesh
    from repro_torch.kernels.stencil import execute_tiles, execute_tiles_sharded

    rng = np.random.default_rng(SEED)
    cases = [(name, tile, batch, n) for name, tile, batch in KERNEL_CASES for n in (2, 3, 4)]
    cases.append((MAIN_PROGRAM, main["tile"], main["largest_wave"], 4))
    worst = 0.0
    for name, tile, batch, n in cases:
        w = get_program(name).widths
        mesh = port_mesh(n, device)
        for dtype in (torch.float32, torch.float64):
            shape = (batch, *(wa + ta for wa, ta in zip(w, tile)))
            halos = _pad(rng_tensor(rng, shape, dtype, device), n)
            got = execute_tiles_sharded(name, halos, tile, mesh)
            want = _sharded_plain(name, halos, tile, n)
            one = execute_tiles(name, halos, tile)
            torch.cuda.synchronize()
            err, err_one = max_abs(got, want), max_abs(got, one)
            log(f"[kernels-sharded] execute_tiles_sharded {name} tile={tile} B={halos.shape[0]} "
                f"({batch} padded) over {n} ports {str(dtype)[6:]}: max|kernel-plain| = "
                f"{err!r}, max|sharded-one launch| = {err_one!r}")
            if not (bit_equal(got, want) and bit_equal(got, one)
                    and bool(torch.isfinite(got).all())):
                raise AssertionError(f"execute_tiles_sharded {name} {dtype} {n} ports: differs")
            worst = max(worst, err, err_one)
    return worst


def phase_sharded(device, main: dict) -> dict:
    """The multi-port path, once, through the front door at full size:
    ``compile(..., n_ports=4)`` with ``[main]``'s layout, the auto backend
    (``sharded``), run with ``use_kernel=True``; its facets must equal
    ``[main]``'s bit for bit, and every wave (padded to 4 shards) must
    launch the tile kernel once per port."""
    from repro_torch import cfa
    from repro_torch.kernels.stencil import execute_tiles, execute_tiles_sharded

    n_ports, space = 4, main["space"]
    t0 = time.perf_counter()
    compiled = cfa.compile(MAIN_PROGRAM, space, n_ports=n_ports, layout=main["layout"],
                           device=device)
    t_compile = time.perf_counter() - t0
    pipe = compiled.pipeline
    waves = pipe.wavefronts()
    log(f"[sharded] {compiled.describe()}")
    log(f"[sharded] compile {t_compile:.2f} s; layout {compiled.layout.key}, backend "
        f"{compiled.backend}, facet->port {pipe.port_assignment.facet_to_port}, "
        f"{math.prod(pipe.num_tiles)} tiles in {len(waves)} waves")
    if compiled.backend != "sharded":
        raise AssertionError(f"auto backend is {compiled.backend!r}, not 'sharded'")
    x = seeded_inputs(MAIN_PROGRAM, space, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    execute_tiles.launches = execute_tiles_sharded.launches = 0
    t0 = time.perf_counter()
    facets = compiled(x, dtype=torch.float32, use_kernel=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"stencil_tiles": execute_tiles.launches,
                "execute_tiles_sharded": execute_tiles_sharded.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"[sharded] sharded backend, {n_ports} ports (CUDA streams), use_kernel: {wall:.3f} s "
        f"wall (host clock around synchronize), {math.prod(space) / wall:.4g} points/s; "
        f"[main] cuda backend {main['wall']:.3f} s; {len(waves)} waves, launches {launches} "
        f"= {launches['stencil_tiles'] / n_ports:g} per port; max_memory_allocated "
        f"{peak / 2**30:.3f} GiB")
    want = len(waves) * n_ports
    if launches["stencil_tiles"] != want or launches["execute_tiles_sharded"] != want:
        raise AssertionError(f"launches {launches} for {len(waves)} waves x {n_ports} ports")
    if not facets_equal(facets, main["facets"]):
        raise AssertionError("sharded facets differ from [main]'s: " + str(
            {k: max_abs(facets[k], main["facets"][k]) for k in facets}))
    log("[sharded] facets == [main]'s (== the reference backend's), bit for bit")
    return {"launches": launches["execute_tiles_sharded"], "wall": wall,
            "waves": len(waves), "n_ports": n_ports}


def phase_fetch_sharded(device, irr: dict) -> dict:
    """The read engine over port-resident facets, once: ``[irredundant]``'s
    payload placed on 4 ports by ``assign_ports``; bit-equal to the plain
    version and to ``[irredundant]``'s fetch."""
    from repro_torch.core.cfa import IterSpace, Tiling, assign_ports, get_program
    from repro_torch.kernels.facet_fetch import (fetch_interior_halos_ref,
                                                 fetch_interior_halos_sharded)

    payload, space, tile = irr["payload"], irr["space"], irr["tile"]
    pa = assign_ports(IterSpace(space), get_program(MAIN_PROGRAM).deps, Tiling(tile), 4)
    torch.cuda.synchronize()
    fetch_interior_halos_sharded.launches = 0
    t0 = time.perf_counter()
    got = fetch_interior_halos_sharded(MAIN_PROGRAM, payload, space, tile, pa,
                                       storage="irredundant")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fetch_interior_halos_sharded.launches
    plain = fetch_interior_halos_ref(MAIN_PROGRAM, payload, space, tile, storage="irredundant")
    err = max_abs(got, plain)
    ok = bit_equal(got, plain) and bit_equal(got, irr["halos"]) and bool(torch.isfinite(got).all())
    del plain
    log(f"[fetch-sharded] fetch_interior_halos_sharded {MAIN_PROGRAM} irredundant, facet->port "
        f"{pa.facet_to_port} over 4 ports: {wall * 1e3:.3f} ms wall -> {tuple(got.shape)}, "
        f"{launches} launch(es); max|kernel-plain| = {err!r}; == [irredundant]'s fetch: "
        f"{bit_equal(got, irr['halos'])}; {_bursts(MAIN_PROGRAM, payload, space, tile, 'irredundant')}")
    if not ok or launches != 1:
        raise AssertionError(f"fetch_interior_halos_sharded: differs ({err!r}) or "
                             f"{launches} launches")
    return {"launches": launches, "err": err, "assignment": pa}


def phase_distribute(device) -> None:
    """``compile(host_budget=2000)`` at (8, 8, 8), layout (4, 4, 4): the
    distribute pass raises ``n_ports`` to 2 and lowers to ``sharded``;
    facets (host path and kernel path) equal the card's ``reference``
    backend bit for bit."""
    from repro_torch import cfa

    name, space, tile = MAIN_PROGRAM, (8, 8, 8), (4, 4, 4)
    compiled = cfa.compile(name, space, layout=tile, host_budget=2000, device=device)
    log(f"[distribute] {name} @ {space} layout {tile} host_budget 2000: n_ports "
        f"{compiled.n_ports}, distributed {compiled.distributed}, backend {compiled.backend}")
    if (compiled.n_ports, compiled.distributed, compiled.backend) != (2, True, "sharded"):
        raise AssertionError("the distribute pass did not lower to 2 ports / sharded")
    x = seeded_inputs(name, space, "cpu", torch.float64)
    reference = cfa.compile(name, space, layout=tile, backend="reference", device=device)
    for dtype in (torch.float32, torch.float64):
        ref = reference(x, dtype=dtype)
        for use_kernel in (False, True):
            got = compiled(x, dtype=dtype, use_kernel=use_kernel)
            torch.cuda.synchronize()
            if not facets_equal(got, ref):
                raise AssertionError(f"distribute {dtype} use_kernel={use_kernel}: differs from "
                                     f"the reference backend")
    log("[distribute] facets == reference backend on the card, bit for bit, float32 and "
        "float64, host and kernel path")


def phase_halo_quantize(device) -> None:
    """``compile(..., n_ports=2, halo_quantize=True)`` on the card against
    the same call on the CPU: the same facets bit for bit (the quantizer
    divides by a 0-d tensor, as the CPU does; the tile kernel is bit-exact
    against its plain version), and lossy against the exact sweep."""
    from repro_torch import cfa

    for name, space, tile in SMALL_CASES:
        x = seeded_inputs(name, space, "cpu", torch.float64)
        card = cfa.compile(name, space, layout=tile, n_ports=2, halo_quantize=True, device=device)
        cpu = cfa.compile(name, space, layout=tile, n_ports=2, halo_quantize=True, device="cpu")
        cpu_exact = cfa.compile(name, space, layout=tile, n_ports=2, device="cpu")
        for dtype in (torch.float32, torch.float64):
            want = cpu(x, dtype=dtype)
            exact = cpu_exact(x, dtype=dtype)
            lossy = max(max_abs(want[k], exact[k]) for k in want)
            for use_kernel in (False, True):
                got = card(x, dtype=dtype, use_kernel=use_kernel)
                torch.cuda.synchronize()
                err = max(max_abs(got[k].cpu(), want[k]) for k in want)
                if not facets_equal({k: v.cpu() for k, v in got.items()}, want):
                    raise AssertionError(f"halo_quantize {name} {dtype} use_kernel={use_kernel}: "
                                         f"card and CPU differ by {err!r}")
            log(f"[halo-quantize] {name} @ {space} tile {tile} {str(dtype)[6:]}, 2 ports: card "
                f"== CPU bit for bit (host and kernel path); quantized vs exact sweep "
                f"{lossy!r}")


def phase_calibrate(device, smi: str):
    """The measurement layer on the card: ``calibrate`` over its default
    sweep against the committed ``H100_HBM3`` preset."""
    from repro_torch import cfa
    from repro_torch.core.cfa.calibrate import _STORAGES

    preset = cfa.H100_HBM3
    t0 = time.perf_counter()
    cal = cfa.calibrate(preset, device=device)
    secs = time.perf_counter() - t0
    fit = cal.fitted
    long = cfa.calibrate(preset, lengths=PRESET_LENGTHS, device=device)
    n_synth = sum(s.label.startswith("synthetic/") for s in cal.samples)
    log(f"[calibrate] calibrate({preset.name}, device={str(device)!r}): {len(cal.samples)} "
        f"samples ({n_synth} synthetic, {len(cal.samples) - n_synth} plan) in {secs:.2f} s, "
        f"noise {cal.noise!r}")
    log(f"[calibrate] committed preset: setup_s {preset.setup_s!r}, peak_bytes_per_s "
        f"{preset.peak_bytes_per_s!r}, elem_bytes {preset.elem_bytes}")
    log(f"[calibrate] fitted on this card: setup_s {fit.setup_s!r}, peak_bytes_per_s "
        f"{fit.peak_bytes_per_s!r}, port factors {dict(fit.port_factors)}"
        + (" (no positive byte term: the fit kept the preset's peak)"
           if fit.peak_bytes_per_s == preset.peak_bytes_per_s else ""))
    log(f"[calibrate] fitted over the preset's sweep (lengths {PRESET_LENGTHS}): setup_s "
        f"{long.fitted.setup_s!r}, peak_bytes_per_s {long.fitted.peak_bytes_per_s!r}, port "
        f"factors {dict(long.fitted.port_factors)}, worst plan error preset "
        f"{long.max_rel_err('modeled')!r}, fit {long.max_rel_err('fitted')!r}, noise "
        f"{long.noise!r}")
    log(f"[calibrate] worst plan error: preset {cal.max_rel_err('modeled')!r}, fit "
        f"{cal.max_rel_err('fitted')!r} over {len(cal.plan_errors)} plan rows")
    for r in cal.plan_errors:
        log(f"[calibrate]   {r['program']}/{r['storage']}/p{r['n_ports']}: {r['n_bursts']} "
            f"bursts, measured {r['measured_s']!r} s, preset {r['modeled_s']!r} s, fit "
            f"{r['fitted_s']!r} s")
    log(f"[calibrate] card (name, power limit): {smi}")
    params = [v for m in (fit, long.fitted)
              for v in (m.setup_s, m.peak_bytes_per_s, *(f for _, f in m.port_factors))]
    if not all(math.isfinite(v) and v > 0.0 for v in params):
        raise AssertionError(f"fitted parameters not finite and positive: {params}")
    want = {(prog, st, p) for prog in ("jacobi2d5p", "heat3d") for st in _STORAGES
            for p in (1, 2)}
    got = {(r["program"], r["storage"], r["n_ports"]) for r in cal.plan_errors}
    if got != want or len(cal.plan_errors) != len(want):
        raise AssertionError(f"plan rows {sorted(got)} are not {sorted(want)}")
    if not all(r["measured_s"] > 0.0 for r in cal.plan_errors):
        raise AssertionError("a plan row measured no time")
    if cfa.Calibration.from_json(cal.to_json()) != cal:
        raise AssertionError("the calibration record does not survive its JSON round trip")
    log("[calibrate] fitted parameters finite and positive, all plan rows present, JSON "
        "round trip equal")
    return cal


def phase_h100_target(device, space=H100_SPACE) -> dict:
    """The front door under the ``h100-hbm3`` target at full width: a
    measured layout search, a verified compile, a run on the kernel."""
    from repro_torch import cfa
    from repro_torch.kernels.stencil import execute_tiles

    target = cfa.get_target("h100-hbm3")
    t0 = time.perf_counter()
    decision = cfa.autotune(MAIN_PROGRAM, space, target.model, score="measured",
                            measure_top=3, measure_kwargs={"device": "cuda"})
    t_search = time.perf_counter() - t0
    axi = cfa.autotune(MAIN_PROGRAM, space, cfa.AXI_ZC706)
    log(f"[h100-target] {MAIN_PROGRAM} @ {space}: autotune(h100-hbm3, score='measured', "
        f"measure_top=3) {t_search:.2f} s{' [cache]' if decision.from_cache else ''}: best "
        f"{decision.best.candidate.key}, best cfa {decision.best_cfa().candidate.key}; "
        f"axi-zc706 (modeled) chooses {axi.best_cfa().candidate.key}")
    for s in decision.ranked[:3]:
        log(f"[h100-target]   {s.candidate.key}: measured {s.measured_time_s!r} s, modeled "
            f"{s.time_s!r} s, model error {s.model_error!r}")
    t0 = time.perf_counter()
    compiled = cfa.compile(MAIN_PROGRAM, space, target="h100-hbm3", layout=decision,
                           verify=True, device=device)
    t_compile = time.perf_counter() - t0
    report = compiled.diagnostics()
    log(f"[h100-target] compile(target='h100-hbm3', verify=True) {t_compile:.2f} s: "
        f"{compiled.describe()}")
    log(f"[h100-target] verify: codes {list(report.codes)}, max severity "
        f"{report.max_severity}, analyses {[a for a, _ in report.analyses]}")
    if report.errors or compiled.backend != "cuda":
        raise AssertionError(f"backend {compiled.backend!r}, errors {report.errors}")
    waves = len(compiled.pipeline.wavefronts())
    x = seeded_inputs(MAIN_PROGRAM, space, device)
    torch.cuda.synchronize()
    execute_tiles.launches = 0
    t0 = time.perf_counter()
    facets = compiled(x, dtype=torch.float32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = execute_tiles.launches
    ref = compiled.lower("reference")(x, dtype=torch.float32)
    torch.cuda.synchronize()
    log(f"[h100-target] cuda backend: {wall:.3f} s wall, {math.prod(space) / wall:.4g} "
        f"points/s, {launches} stencil_tiles launches for {waves} waves "
        f"(tile {compiled.pipeline.tiling.sizes})")
    if launches != waves:
        raise AssertionError(f"{launches} kernel launches for {waves} waves")
    if not facets_equal(facets, ref):
        raise AssertionError("h100-target facets differ from the reference backend")
    log("[h100-target] facets == reference backend bit for bit")
    # the same path at axi-zc706's choice, for the wall beside it
    axi_compiled = cfa.compile(MAIN_PROGRAM, space, layout=axi, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    axi_facets = axi_compiled(x, dtype=torch.float32)
    torch.cuda.synchronize()
    axi_wall = time.perf_counter() - t0
    log(f"[h100-target] axi-zc706's layout {axi_compiled.layout.key} on the same path: "
        f"{axi_wall:.3f} s wall, {len(axi_compiled.pipeline.wavefronts())} waves; h100-hbm3's "
        f"wall / axi-zc706's {wall / axi_wall:.4f}")
    del axi_facets
    rep = compiled.report(measured=True)
    log(f"[h100-target] report(measured=True): modeled {target.model.time(compiled.plan)!r} s, "
        f"measured {rep.measured_time_s!r} s, model_error {rep.model_error!r}")
    rr = compiled.runtime_report()
    for r in rr.rows[:3]:
        log(f"[h100-target]   runtime_report {r.key}: observed {r.observed_s!r} s, modeled "
            f"{r.modeled_s!r} s, deviation {r.deviation!r}, fixit {r.fixit}")
    if not (rep.measured_time_s and rep.measured_time_s > 0.0 and rr.rows):
        raise AssertionError("the measured report or the runtime report is empty")
    return {"launches": launches, "waves": waves, "wall": wall,
            "layout": compiled.layout.key}


def _lane_overlap(trace: Path) -> str:
    """From a Chrome trace of a dataflow run: the device time of the kernels
    on the compute stream (the stencil launches) and how much of it overlaps
    kernels on other streams (gathers and commits)."""
    events = json.loads(trace.read_text()).get("traceEvents", [])
    by_stream: dict = {}
    for e in events:
        if e.get("cat") == "kernel" and e.get("ph") == "X":
            s = e.get("args", {}).get("stream")
            by_stream.setdefault(s, []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                                                e.get("name", "")))
    stencil = [s for s, ks in by_stream.items() if any("stencil_tiles" in k[2] for k in ks)]
    if len(stencil) != 1:
        return f"not measured (stencil kernels on streams {stencil} of {sorted(map(str, by_stream))})"
    comp = by_stream[stencil[0]]
    others = sorted(iv for s, ks in by_stream.items() if s != stencil[0] for iv in ks)
    busy = sum(b - a for a, b, _ in comp)
    overlap = 0.0
    for a, b, _ in comp:
        for c, d, _ in others:
            if c >= b:
                break
            overlap += max(0.0, min(b, d) - max(a, c))
    return (f"{len(comp)} kernels on the compute stream, {busy:.1f} us; {overlap:.1f} us of it "
            f"({overlap / busy:.1%}) overlaps {len(others)} kernels on {len(by_stream) - 1} other "
            f"stream(s)")


def _dataflow_profile(device, layout, space) -> None:
    """A traced and profiled dataflow run at a cut space: host spans must
    show prefetch and commit inside compute (the concurrent lanes), the
    profiler counts the host's synchronising calls and the device overlap
    of the compute stream with the gathers and commits."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import cfa

    compiled = cfa.compile(MAIN_PROGRAM, space, overlap=True, layout=layout, device=device)
    x = seeded_inputs(MAIN_PROGRAM, space, device)
    compiled(x, dtype=torch.float32, use_kernel=True)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        compiled(x, dtype=torch.float32, use_kernel=True, trace=True)
        torch.cuda.synchronize()
    n_tiles = math.prod(compiled.pipeline.num_tiles)
    syncs = {e.key: e.count for e in prof.key_averages()
             if "Synchronize" in e.key or e.key in ("cudaMemcpy", "cudaStreamWaitEvent")}
    out = ROOT / "build" / "profile"
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "dataflow.json"))
    rec = compiled.last_trace()
    compute, fetch, commit = (rec.find(n) for n in ("execute_tile", "copy_in", "copy_out"))

    def inside(inner, outer):
        return outer.t0 <= inner.t0 and inner.t0 + inner.dur <= outer.t0 + outer.dur

    expected = sum(len(w) - 1 for w in compiled.pipeline.wavefronts())
    f_in = sum(any(inside(f, c) for c in compute) for f in fetch)
    c_in = sum(any(inside(w, c) for c in compute) for w in commit)
    log(f"[dataflow] profiled at {space} ({n_tiles} tiles, {len(compute)} compute spans): "
        f"host calls {syncs} (the last synchronize is the window's own); spans: {f_in} "
        f"prefetches and {c_in} commits inside a compute span (structural floor {expected}); "
        f"device: {_lane_overlap(out / 'dataflow.json')}")
    if not (rec.reconcile(compiled.pipeline)["ok"] and f_in >= expected and c_in >= expected):
        raise AssertionError("dataflow trace: lanes not concurrent or counters do not reconcile")


def phase_dataflow(device, main: dict) -> dict:
    """The overlapped path, once, through the front door at full size:
    ``compile(..., overlap=True)`` with ``[main]``'s layout (auto backend
    ``dataflow``), run with ``use_kernel=True`` — one tile-kernel launch per
    tile; facets must equal ``[main]``'s bit for bit.  Its wall beside
    ``[main]``'s is the overlap factor."""
    from repro_torch import cfa
    from repro_torch.kernels.stencil import execute_tiles

    space = main["space"]
    compiled = cfa.compile(MAIN_PROGRAM, space, overlap=True, layout=main["layout"],
                           device=device)
    n_tiles = math.prod(compiled.pipeline.num_tiles)
    log(f"[dataflow] {compiled.describe()}")
    if compiled.backend != "dataflow":
        raise AssertionError(f"auto backend is {compiled.backend!r}, not 'dataflow'")
    x = seeded_inputs(MAIN_PROGRAM, space, device)
    torch.cuda.synchronize()
    execute_tiles.launches = 0
    t0 = time.perf_counter()
    facets = compiled(x, dtype=torch.float32, use_kernel=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = execute_tiles.launches
    log(f"[dataflow] dataflow backend, use_kernel: {wall:.3f} s wall (host clock around "
        f"synchronize), {math.prod(space) / wall:.4g} points/s, {launches} stencil_tiles "
        f"launches for {n_tiles} tiles; [main] cuda backend {main['wall']:.3f} s: overlap "
        f"factor (main wall / dataflow wall) {main['wall'] / wall:.4f}")
    if launches != n_tiles:
        raise AssertionError(f"{launches} stencil_tiles launches for {n_tiles} tiles")
    if not facets_equal(facets, main["facets"]):
        raise AssertionError("dataflow facets differ from [main]'s: " + str(
            {k: max_abs(facets[k], main["facets"][k]) for k in facets}))
    log("[dataflow] facets == [main]'s (== the reference backend's), bit for bit")
    del facets
    _dataflow_profile(device, main["layout"], (min(8, space[0]), *space[1:]))
    return {"launches": launches, "wall": wall}


def phase_sharded_timing(device, main: dict, irr: dict, fetch_row: dict,
                         assignment) -> dict:
    """1s at the main path's full-size wave over 4 port streams against one
    launch of kernel 1 over the whole wave; 2s against kernel 2, at the
    irredundant path's shapes.  Bounds as for kernels 1 and 2; no PyTorch
    call computes either function (library time null)."""
    from repro_torch.distributed.sharding import port_mesh
    from repro_torch.kernels.facet_fetch import (fetch_interior_halos, fetch_interior_halos_ref,
                                                 fetch_interior_halos_sharded)
    from repro_torch.kernels.stencil import execute_tiles, execute_tiles_sharded

    rows = {}
    n, tile, w = 4, main["tile"], main["widths"]
    mesh = port_mesh(n, device)
    shape = (main["largest_wave"], *(wa + ta for wa, ta in zip(w, tile)))
    halos = _pad(rng_tensor(np.random.default_rng(SEED), shape, torch.float32, device), n)
    err = max_abs(execute_tiles_sharded(MAIN_PROGRAM, halos, tile, mesh),
                  _sharded_plain(MAIN_PROGRAM, halos, tile, n))
    sharded_m, one_m = [], []
    for _ in range(2):  # in turns: sharded, one launch, sharded, one launch
        sharded_m.append(_measure(lambda: execute_tiles_sharded(MAIN_PROGRAM, halos, tile, mesh),
                                  100))
        one_m.append(_measure(lambda: execute_tiles(MAIN_PROGRAM, halos, tile), 100))
    ms, one = statistics.median(t["ms"] for t in sharded_m), statistics.median(
        t["ms"] for t in one_m)
    host_ms = statistics.median(t["host_ms"] for t in sharded_m)
    plain_ms = _time_ms(lambda: _sharded_plain(MAIN_PROGRAM, halos, tile, n), 10, warmup=2)[0]
    bound_ms, bound_by = _stencil_bound(MAIN_PROGRAM, halos, tile)
    log(f"[timing] execute_tiles_sharded {MAIN_PROGRAM} main-path wave: B={halos.shape[0]} halo "
        f"{tuple(halos.shape[1:])} float32 over {n} port streams: {_fmt(sharded_m[0])}; again "
        f"{_fmt(sharded_m[1])}; one execute_tiles launch over the wave {_fmt(one_m[0])}; again "
        f"{_fmt(one_m[1])}; plain (per shard) {plain_ms:.6f} ms (eager CUDA events), bound "
        f"{bound_ms:.6f} ms ({bound_by}), {bound_ms / ms:.1%} of bound, max|kernel-plain| {err!r}")
    if err != 0.0:
        raise AssertionError(f"execute_tiles_sharded differs from plain at the wave: {err!r}")
    rows["execute_tiles_sharded"] = {"ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                                     "bound_ms": bound_ms, "bound_by": bound_by,
                                     "library_ms": None, "err": err, "one_launch_ms": one}

    payload, space, ftile = irr["payload"], irr["space"], irr["tile"]

    def sharded():
        return fetch_interior_halos_sharded(MAIN_PROGRAM, payload, space, ftile, assignment,
                                            mesh, storage="irredundant")

    def kernel2():
        return fetch_interior_halos(MAIN_PROGRAM, payload, space, ftile, storage="irredundant")

    f = _measure(sharded, 20)
    k = _measure(kernel2, 20)
    f_plain = _time_ms(lambda: fetch_interior_halos_ref(
        MAIN_PROGRAM, payload, space, ftile, storage="irredundant"), 3, warmup=1)[0]
    log(f"[timing] fetch_interior_halos_sharded {MAIN_PROGRAM} irredundant over 4 ports: "
        f"{_fmt(f)}; fetch_interior_halos {_fmt(k)} (phase [timing]: {fetch_row['ms']:.6f} ms); "
        f"plain {f_plain:.6f} ms (eager CUDA events), bound {fetch_row['bound_ms']:.6f} ms "
        f"(bytes), {fetch_row['bound_ms'] / f['ms']:.1%} of bound")
    rows["fetch_interior_halos_sharded"] = {
        "ms": f["ms"], "host_ms": f["host_ms"], "plain_ms": f_plain,
        "bound_ms": fetch_row["bound_ms"], "bound_by": "bytes", "library_ms": None}
    return rows


# -- slice 3: LM serving ------------------------------------------------------


def _excess(got: torch.Tensor, want: torch.Tensor, tol: tuple[float, float]) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 within ``tol``
    = (rtol, atol); inf if ``got`` is not finite."""
    g, w = got.double(), want.double()
    if not bool(torch.isfinite(g).all()):
        return math.inf
    rtol, atol = tol
    return float(((g - w).abs() / (atol + rtol * w.abs())).max()) if g.numel() else 0.0


def _attn_lowp(q, k, v, lengths) -> torch.Tensor:
    """The control: decode attention with every step in ``q.dtype``
    (bfloat16 scores, softmax and products), over the canonical cache."""
    B, S, Hkv, D = k.shape
    Hq = q.shape[1]
    s = torch.einsum("bhgd,bshd->bhgs", q.reshape(B, Hkv, Hq // Hkv, D), k) / math.sqrt(D)
    mask = torch.arange(S, device=q.device)[None, :] < lengths[:, None].long()
    s = torch.where(mask[:, None, None, :], s, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bhgs,bshd->bhgd", p, v).reshape(B, Hq, D)


def _ssd_lowp(x, loga, Bm, C, chunk) -> torch.Tensor:
    """The control: the chunked SSD (``ssd_chunked_ref``'s math) with every
    step, the carried state included, in ``x.dtype``."""
    dt = x.dtype
    Bb, T, H, P = x.shape
    N, L, nc = Bm.shape[-1], chunk, T // chunk
    xc, lc = x.reshape(Bb, nc, L, H, P), loga.to(dt).reshape(Bb, nc, L, H)
    Bc, Cc = Bm.reshape(Bb, nc, L, N), C.reshape(Bb, nc, L, N)
    idx = torch.arange(L, device=x.device)
    mask = (idx[:, None] >= idx[None, :])[None, :, :, None]
    S = x.new_zeros((Bb, H, P, N))
    ys = []
    for c in range(nc):
        xk, Bk, Ck = xc[:, c], Bc[:, c], Cc[:, c]
        lcum = torch.cumsum(lc[:, c], 1)
        ltot = lcum[:, -1]
        y = torch.exp(lcum)[..., None] * torch.einsum("bln,bhpn->blhp", Ck, S)
        W = torch.exp(lcum[:, :, None] - lcum[:, None]) * torch.einsum("bln,bsn->bls", Ck, Bk)[..., None]
        y = y + torch.einsum("blsh,bshp->blhp", torch.where(mask, W, W.new_zeros(())), xk)
        S = torch.exp(ltot)[..., None, None] * S + torch.einsum(
            "blhp,bln->bhpn", xk * torch.exp(ltot[:, None] - lcum)[..., None], Bk)
        ys.append(y)
    return torch.stack(ys, 1).reshape(Bb, T, H, P)


def _serve_prompt_lens(rng) -> np.ndarray:
    """The serve stream's prompt lengths: ``rng``'s first draw."""
    return rng.integers(SERVE_PROMPTS[0], SERVE_PROMPTS[1] + 1, size=SERVE_REQUESTS)


def phase_attn_kernel(device) -> float:
    """``decode_attention`` against its plain version (``decode_attention_ref``
    over ``deblockify``, as the wrapper runs it on the CPU); in bfloat16 also a
    control computed in bfloat16 throughout, which the limit must reject."""
    from repro_torch.kernels.block_attention import (blockify, deblockify, decode_attention,
                                                     decode_attention_ref)

    rng = np.random.default_rng(SEED)
    worst, control = 0.0, 0.0
    for B, Hq, Hkv, D, S, bs, lens in ATTN_CASES:
        q = rng_tensor(rng, (B, Hq, D), torch.float32, device)
        kc = rng_tensor(rng, (B, S, Hkv, D), torch.float32, device)
        vc = rng_tensor(rng, (B, S, Hkv, D), torch.float32, device)
        lens = rng.integers(1, S + 1, size=B) if lens is None else np.asarray(lens)
        lengths = torch.as_tensor(lens, dtype=torch.int32, device=device)
        for qdt, kvdt in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                          (torch.float32, torch.bfloat16)):
            tol = ATTN_TOL[qdt]
            qq, kb, vb = q.to(qdt), blockify(kc.to(kvdt), bs), blockify(vc.to(kvdt), bs)
            got = decode_attention(qq, kb, vb, lengths)
            want = decode_attention_ref(qq, deblockify(kb), deblockify(vb), lengths)
            torch.cuda.synchronize()
            err, ex = max_abs(got, want), _excess(got, want, tol)
            note = ""
            if qdt == torch.bfloat16:
                ctrl = _excess(_attn_lowp(qq, deblockify(kb), deblockify(vb), lengths), want, tol)
                control = max(control, ctrl)
                note = f"; bfloat16-throughout control {ctrl:.3f} x the limit"
            log(f"[attn-kernel] decode_attention B={B} Hq={Hq} Hkv={Hkv} D={D} S={S} bs={bs} "
                f"lengths={lens.tolist()} q {str(qdt)[6:]} K/V {str(kvdt)[6:]}: "
                f"max|kernel-plain| = {err!r}, {ex:.3f} x the limit (rtol, atol) = {tol}{note}")
            if got.dtype != qdt or not ex <= 1.0:
                raise AssertionError(f"decode_attention differs from its plain version by {err!r}")
            worst = max(worst, err)
    if not control > 1.0:
        raise AssertionError(f"the bfloat16 limit {ATTN_TOL[torch.bfloat16]} does not reject a "
                             f"bfloat16-throughout control ({control:.3f} x the limit)")
    _attn_wrapper_proof(device, q.to(torch.bfloat16), kb, vb)  # the last case: qwen3's, K/V bf16
    return worst


def _attn_wrapper_proof(device, q, kb, vb, n_calls: int = 10) -> None:
    """The wrapper as the model calls it, at qwen3-0.6b's shape: int64
    lengths broadcast from one position (``(pos + 1).expand(B)``).  Over
    ``n_calls`` profiled calls the card runs only the kernel, once per call
    (no cast or copy launch), and the host makes no stream synchronize and
    no device-to-host copy; a call captured in a CUDA graph and replayed
    equals the eager call bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.block_attention import decode_attention

    B = q.shape[0]
    lengths = (torch.tensor(700, device=device) + 1).expand(B)
    eager = decode_attention(q, kb, vb, lengths)
    torch.cuda.synchronize()
    before = decode_attention.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_calls):
            decode_attention(q, kb, vb, lengths)
        torch.cuda.synchronize()  # the window's own (a device synchronize)
    launches = decode_attention.launches - before
    rows = prof.key_averages()
    # device activity: kernels, copies and fills (runtime-API rows start with "cuda")
    kernels = {e.key: e.count for e in rows if not e.key.startswith("cuda") and (
        e.key.startswith(("void ", "Memcpy", "Memset")) or "_kernel" in e.key)}
    host = {e.key: e.count for e in rows if e.key.startswith("cuda")
            and ("Synchronize" in e.key or "Memcpy" in e.key)}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attention(q, kb, vb, lengths)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = decode_attention(q, kb, vb, lengths)
    graph.replay()
    torch.cuda.synchronize()
    same = bit_equal(captured, eager)
    del graph
    log(f"[attn-kernel] wrapper at B={B} {tuple(kb.shape)} {str(q.dtype)[6:]}, int64 lengths "
        f"broadcast (stride {lengths.stride(0)}): {n_calls} profiled calls -> {launches} launches, "
        f"device kernels {kernels}, host sync/copy calls {host or 'none'}; graph replay == "
        f"eager bit for bit: {same}")
    names = list(kernels)
    if not (launches == n_calls and len(names) == 1 and "decode_attention" in names[0]
            and kernels[names[0]] == n_calls):
        raise AssertionError(f"decode_attention launched more than its kernel: {kernels}")
    if any(n for k, n in host.items() if "StreamSynchronize" in k or "Memcpy" in k):
        raise AssertionError(f"decode_attention made host syncs or copies: {host}")
    if not same:
        raise AssertionError("a captured decode_attention differs from the eager call")


def _prefix_states(x, loga, Bm, C, chunk) -> torch.Tensor:
    """The state entering every chunk by the plain version, (B, T/chunk, H,
    P, N) float32: zero before the first chunk, then ``ssd_chunked_ref``'s
    final state on the prefix before each chunk."""
    from repro_torch.kernels.ssd import ssd_chunked_ref

    B, T, H, P = x.shape
    out = [torch.zeros((B, H, P, Bm.shape[-1]), dtype=torch.float32, device=x.device)]
    for n in range(chunk, T, chunk):
        out.append(ssd_chunked_ref(x[:, :n], loga[:, :n], Bm[:, :n], C[:, :n], chunk)[1])
    return torch.stack(out, 1)


def _ssd_states_check(args, chunk: int, tol, wy, wst, serve=None) -> tuple[float, float]:
    """The training route (``_forward(save_states=True)``, the launch that
    ``_SsdScan`` makes) against the plain version: y and the final state to
    their limits, and each saved chunk state to ``_prefix_states`` within
    STATE_TOL; logs whether y and the state equal the serving route's
    (``serve``) bit for bit.  Returns (max error, max excess)."""
    from repro_torch.kernels.ssd import ssd as ssd_mod

    y, st, states = ssd_mod._forward(*args, chunk, save_states=True)
    want = _prefix_states(*args, chunk)
    torch.cuda.synchronize()
    ex = [_excess(y, wy, tol), _excess(st, wst, STATE_TOL), _excess(states, want, STATE_TOL)]
    errs = [max_abs(y, wy), max_abs(st, wst), max_abs(states, want)]
    same = "" if serve is None else (f"; y and the state == the serving route's bit for bit: "
                                     f"{bit_equal(y, serve[0]) and bit_equal(st, serve[1])}")
    B, T, H, P = args[0].shape
    log(f"[ssd-kernel] ssd_scan training route (per-chunk states saved) B={B} T={T} H={H} "
        f"P={P} N={args[2].shape[-1]} chunk={chunk} {str(args[0].dtype)[6:]}: max|kernel-plain| "
        f"y / final state / the {states.shape[1]} chunk states = "
        f"{', '.join(repr(e) for e in errs)}; x the limit {', '.join(f'{e:.3f}' for e in ex)}"
        f"{same}")
    if y.dtype != args[0].dtype or not max(ex) <= 1.0:
        raise AssertionError(f"ssd_scan's training route differs from its plain version: "
                             f"y, state, chunk states {errs}")
    del states, want
    return max(errs), max(ex)


def phase_ssd_kernel(device) -> float:
    """``ssd_scan`` against its plain version (``ssd_chunked_ref``), y and
    the final state, on the test shapes, mamba2-370m's and the serve
    stream's prompts shorter than a chunk (run with chunk = T); in bfloat16
    also a control computed in bfloat16 throughout, which the limit must
    reject.  The training route, which also saves the state entering every
    chunk, on ``SSD_CASES`` and the training shape: y and the final state to
    the same limits, each saved state to the plain version's on the prefix
    before its chunk."""
    from repro_torch.kernels.ssd import ssd_chunked_ref, ssd_scan

    cfg = _serve_cfg("mamba2-370m")
    short = sorted({int(n) for n in _serve_prompt_lens(np.random.default_rng(SEED))
                    if n < cfg.ssm_chunk})
    cases = SSD_CASES + [(1, n, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, n) for n in short]
    rng = np.random.default_rng(SEED)
    worst, control = 0.0, 0.0
    for B, T, H, P, N, chunk in cases:
        x = rng_tensor(rng, (B, T, H, P), torch.float32, device)
        loga = -rng_tensor(rng, (B, T, H), torch.float32, device).abs() * 0.5
        Bm = rng_tensor(rng, (B, T, N), torch.float32, device) / math.sqrt(N)
        C = rng_tensor(rng, (B, T, N), torch.float32, device) / math.sqrt(N)
        for dt in (torch.float32, torch.bfloat16):
            tol = SSD_TOL[dt]
            args = (x.to(dt), loga, Bm.to(dt), C.to(dt))
            y, st = ssd_scan(*args, chunk=chunk)
            wy, wst = ssd_chunked_ref(*args, chunk)
            torch.cuda.synchronize()
            err_y, err_s = max_abs(y, wy), max_abs(st, wst)
            ex_y, ex_s = _excess(y, wy, tol), _excess(st, wst, STATE_TOL)
            note = ""
            if dt == torch.bfloat16:
                ctrl = _excess(_ssd_lowp(*args, chunk), wy, tol)
                control = max(control, ctrl)
                note = f"; bfloat16-throughout control {ctrl:.3f} x the limit"
            log(f"[ssd-kernel] ssd_scan B={B} T={T} H={H} P={P} N={N} chunk={chunk} "
                f"{str(dt)[6:]}: max|kernel-plain| y = {err_y!r}, {ex_y:.3f} x the limit "
                f"(rtol, atol) = {tol}; state = {err_s!r}, {ex_s:.3f} x {STATE_TOL}{note}")
            if y.dtype != dt or not (ex_y <= 1.0 and ex_s <= 1.0):
                raise AssertionError(f"ssd_scan differs from its plain version: y {err_y!r}, "
                                     f"state {err_s!r}")
            worst = max(worst, err_y, err_s)
            if (B, T, H, P, N, chunk) in SSD_CASES:
                worst = max(worst, _ssd_states_check(args, chunk, tol, wy, wst, (y, st))[0])
    B, T, H, P, N, chunk = SSD_TRAIN_SHAPE
    x = rng_tensor(rng, (B, T, H, P), torch.float32, device)
    loga = -rng_tensor(rng, (B, T, H), torch.float32, device).abs() * 0.5
    Bm = rng_tensor(rng, (B, T, N), torch.float32, device) / math.sqrt(N)
    C = rng_tensor(rng, (B, T, N), torch.float32, device) / math.sqrt(N)
    for dt in (torch.float32, torch.bfloat16):
        args = (x.to(dt), loga, Bm.to(dt), C.to(dt))
        wy, wst = ssd_chunked_ref(*args, chunk)
        worst = max(worst, _ssd_states_check(args, chunk, SSD_TOL[dt], wy, wst)[0])
        del wy, wst
    del x, loga, Bm, C
    _free()
    if not control > 1.0:
        raise AssertionError(f"the bfloat16 limit {SSD_TOL[torch.bfloat16]} does not reject a "
                             f"bfloat16-throughout control ({control:.3f} x the limit)")
    return worst


def _ssd_bwd_lowp(x, loga, Bm, C, dy, chunk):
    """The control: the backward of ``_ssd_lowp`` (every step in
    ``x.dtype``) by autograd."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (x, loga, Bm, C)]
        return torch.autograd.grad(_ssd_lowp(*inputs, chunk), inputs, dy)


def _bwd_excess(got, want, dt) -> list[float]:
    """Each output's excess over its limit (dx, dloga, dB, dC)."""
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        if dt == torch.float32 or i == 1:
            rtol, atol = SSD_BWD_F32
            out.append(_excess(g, w, (0.0, rtol * float(w.abs().max()) + atol)))
        else:
            out.append(_excess(g, w, SSD_BWD_BF16))
    return out


def phase_ssd_bwd_kernel(device) -> float:
    """``ssd_scan_bwd`` against its plain version (autograd through
    ``ssd_chunked_ref``) on ``SSD_CASES`` and the training shape, float32
    and bfloat16, with a zero and a seeded final-state gradient; two calls
    bit-equal; in bfloat16 a control computed in bfloat16 throughout, which
    the limit must reject; the gradient through ``ssd_scan`` (``_SsdScan``)
    equal to the direct call; one call captured in a CUDA graph equal to the
    eager call."""
    from repro_torch.kernels.ssd import ssd as ssd_mod
    from repro_torch.kernels.ssd import ssd_chunked_bwd_ref, ssd_scan, ssd_scan_bwd

    rng = np.random.default_rng(SEED)
    worst, control = 0.0, 0.0
    for B, T, H, P, N, chunk in SSD_CASES + [SSD_TRAIN_SHAPE]:
        x = rng_tensor(rng, (B, T, H, P), torch.float32, device)
        loga = -rng_tensor(rng, (B, T, H), torch.float32, device).abs() * 0.5
        Bm = rng_tensor(rng, (B, T, N), torch.float32, device) / math.sqrt(N)
        C = rng_tensor(rng, (B, T, N), torch.float32, device) / math.sqrt(N)
        dy = rng_tensor(rng, (B, T, H, P), torch.float32, device)
        dstate = rng_tensor(rng, (B, H, P, N), torch.float32, device)
        for dt in (torch.float32, torch.bfloat16):
            args = (x.to(dt), loga, Bm.to(dt), C.to(dt))
            _, _, states = ssd_mod._forward(*args, chunk, save_states=True)
            for ds in (None, dstate):
                got = ssd_scan_bwd(*args, dy.to(dt), ds, chunk=chunk, states=states)
                again = ssd_scan_bwd(*args, dy.to(dt), ds, chunk=chunk, states=states)
                want = ssd_chunked_bwd_ref(*args, dy.to(dt), ds, chunk)
                torch.cuda.synchronize()
                ex = _bwd_excess(got, want, dt)
                same = all(bit_equal(a, b) for a, b in zip(got, again))
                errs = [max_abs(a, b) for a, b in zip(got, want)]
                note = ""
                if dt == torch.bfloat16 and ds is None:
                    ctrl = max(_bwd_excess(_ssd_bwd_lowp(*args, dy.to(dt), chunk), want, dt)[i]
                               for i in (0, 2, 3))
                    control = max(control, ctrl)
                    note = f"; bfloat16-throughout control {ctrl:.3f} x the limit"
                log(f"[ssd-bwd-kernel] ssd_scan_bwd B={B} T={T} H={H} P={P} N={N} "
                    f"chunk={chunk} {str(dt)[6:]}, dstate {'seeded' if ds is not None else 0}: "
                    f"max|kernel-plain| dx/dloga/dB/dC = {', '.join(f'{e:.3e}' for e in errs)}; "
                    f"x the limit {', '.join(f'{e:.3f}' for e in ex)}; two calls bit-equal "
                    f"{same}{note}")
                if not (max(ex) <= 1.0 and same) or got[0].dtype != dt or got[1].dtype != \
                        torch.float32:
                    raise AssertionError(f"ssd_scan_bwd differs from its plain version or "
                                         f"between calls: {ex}, deterministic {same}")
                worst = max(worst, *errs)
            del states
        if (B, T, H, P, N, chunk) == SSD_TRAIN_SHAPE:
            args = (x.bfloat16(), loga, Bm.bfloat16(), C.bfloat16())
            _, _, states = ssd_mod._forward(*args, chunk, save_states=True)
            direct = ssd_scan_bwd(*args, dy.bfloat16(), chunk=chunk, states=states)
            leaves = [a.detach().clone().requires_grad_() for a in args]
            y, _ = ssd_scan(*leaves, chunk=chunk)
            through = torch.autograd.grad(y, leaves, dy.bfloat16())
            same_auto = all(bit_equal(a, b) for a, b in zip(through, direct))
            graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                ssd_scan_bwd(*args, dy.bfloat16(), chunk=chunk, states=states)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            with torch.cuda.graph(graph):
                captured = ssd_scan_bwd(*args, dy.bfloat16(), chunk=chunk, states=states)
            graph.replay()
            torch.cuda.synchronize()
            same_graph = all(bit_equal(a, b) for a, b in zip(captured, direct))
            log(f"[ssd-bwd-kernel] training shape, bfloat16: the gradient through ssd_scan "
                f"(_SsdScan) == the direct call bit for bit: {same_auto}; one call captured in "
                f"a CUDA graph and replayed == the eager call: {same_graph}")
            if not (same_auto and same_graph):
                raise AssertionError("ssd_scan_bwd through autograd or graph replay differs")
            del graph, states, captured
        _free()
    if not control > 1.0:
        raise AssertionError(f"the bfloat16 limit {SSD_BWD_BF16} does not reject a "
                             f"bfloat16-throughout control ({control:.3f} x the limit)")
    return worst


def _serve_cfg(arch: str):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), tp=1)


def _logits_along(model, prompt: torch.Tensor, toks=None, cross_src=None) -> tuple[list, list]:
    """Prefill ``prompt`` (with the context ``cross_src``, where the model
    takes one) and decode ``CPU_CHECK_STEPS`` tokens (``toks``, or the
    model's own greedy picks); every step's logits as float32 on the host,
    and the tokens fed."""
    from repro_torch.models.lm import lm_decode, lm_prefill

    cfg = model.cfg
    # float32 compute keeps its caches in float32 too: a bf16 cache would
    # round card and CPU values that straddle a rounding midpoint apart
    cache_dtype = torch.float32 if cfg.compute_dtype == "float32" else torch.bfloat16
    if cross_src is not None:
        cross_src = cross_src.to(model.device)
    logits, caches = lm_prefill(model, prompt.to(model.device), cross_src=cross_src,
                                max_seq=prompt.shape[1] + CPU_CHECK_STEPS,
                                cache_dtype=cache_dtype)
    out, fed = [logits.float().cpu()], []
    for step in range(CPU_CHECK_STEPS):
        tok = torch.argmax(out[-1][:, : cfg.vocab], -1) if toks is None else toks[step]
        logits, caches = lm_decode(model, caches, tok, prompt.shape[1] + step)
        out.append(logits.float().cpu())
        fed.append(tok)
    return out, fed


def _rel_errs(got: list, want: list) -> list[float]:
    """Per step: max |got - want| over max(|want|, 1) (tests/test_archs.py's measure)."""
    errs = []
    for a, b in zip(got, want):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError("non-finite logits in the card/CPU check")
        errs.append(float((a - b).abs().max()) / max(float(b.abs().max()), 1.0))
    return errs


def _copy(model, cfg, device, n_layers: int):
    """``model``'s weights in a model of ``cfg`` on ``device``, cut to its
    first ``n_layers`` layers (an encoder-decoder's encoder too)."""
    from repro_torch.models.lm import LM

    cut = dataclasses.replace(cfg, n_layers=n_layers)
    if cfg.is_encdec:
        cut = dataclasses.replace(cut, enc_layers=min(cfg.enc_layers, n_layers))
    m = LM(cut, device=device)
    keep = m.state_dict()
    m.load_state_dict({k: v for k, v in model.state_dict().items() if k in keep})
    return m


def _context(cfg, rng, batch: int, device) -> torch.Tensor | None:
    """Context embeddings as the launcher draws them (normal * 0.02, bf16),
    for a model with cross-attention; else None."""
    if cfg.family not in ("vlm", "encdec"):
        return None
    x = rng.normal(size=(batch, cfg.n_context_tokens, cfg.d_model)) * 0.02
    return torch.as_tensor(x, dtype=torch.bfloat16, device=device)


@contextlib.contextmanager
def _routes(card: list | None = None):
    """Record every MoE call's top-k choice and its margin (k-th minus
    (k+1)-th probability) into the yielded list, in call order; with
    ``card`` (such a list from the card), the calls use the card's choices
    instead of their own (the probabilities stay their own)."""
    from repro_torch.models import moe as moe_mod

    own = moe_mod.top_k
    log: list = []

    def top_k(probs, k):
        vals, idx = own(probs, k)
        srt = torch.sort(probs, dim=-1, descending=True, stable=True).values
        margin = (srt[..., k - 1] - srt[..., k] if k < probs.shape[-1]
                  else torch.full_like(srt[..., 0], math.inf))
        log.append((idx.cpu(), margin.float().cpu(), probs.float().cpu()))
        if card is not None:
            idx = card[len(log) - 1][0].to(probs.device)
            vals = probs.gather(-1, idx)
        return vals, idx

    moe_mod.top_k = top_k
    try:
        yield log
    finally:
        moe_mod.top_k = own


def _route_flips(card: list, cpu: list) -> list[tuple[float, float]]:
    """The tokens whose top-k expert set differs between the card's choices
    and the CPU's own (made with the card's choices upstream): for each,
    the larger of the two margins and the largest difference between the
    two devices' router probabilities for that token."""
    if len(card) != len(cpu):
        raise AssertionError(f"{len(card)} MoE calls on the card, {len(cpu)} on the CPU")
    flips = []
    for (ia, ma, pa), (ib, mb, pb) in zip(card, cpu):
        differ = ~(ia.sort(-1).values == ib.sort(-1).values).all(-1)
        delta = (pa - pb).abs().amax(-1)
        flips += list(zip(torch.maximum(ma, mb)[differ].tolist(), delta[differ].tolist()))
    return flips


def _flips_text(flips: list) -> str:
    return (f"{len(flips)} token(s)" + ("" if not flips else
            f", largest margin {max(m for m, _ in flips)!r}, largest probability delta "
            f"{max(d for _, d in flips)!r}"))


def _cpu_check(model, cfg, rng) -> dict:
    """One request (prompt 128, 4 decode steps; the model's full context
    where it takes one) on the card and through the same port on the CPU
    with the weights copied over, all runs fed the same tokens.

    float32 compute and caches (bf16 values are exact in float32) at the
    float32 depth of ``CPU_CHECK``: card against CPU within 1e-3 relative
    (only summation order differs).  The served bfloat16: card against CPU
    within 0.06 at the witness depth (the same weights, the model cut after
    them); the errors at the other depths, and the CPU's own
    bf16-against-float32 spread at each, are printed beside it.  With
    experts, each CPU run takes the card run's expert choices; in float32
    the CPU's own choices may differ from them only at near-ties
    (``ROUTE_TIE_F32``), in bfloat16 the differing ones are printed."""
    t0 = time.perf_counter()
    depths, witness, d32 = CPU_CHECK[cfg.name]
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, CPU_CHECK_PROMPT)))
    src = _context(cfg, rng, 1, "cpu")
    full = cfg.n_layers
    with _routes() as routes_full:
        card16, toks = _logits_along(model, prompt, cross_src=src)
    e16, spread, flips16 = {}, {}, []
    for d in sorted(set(depths) | {witness, d32}):
        if d == full:
            card, routes = card16, routes_full
        else:
            with _routes() as routes:
                card = _logits_along(_copy(model, cfg, model.device, d), prompt, toks, src)[0]
        with _routes(routes) as own:
            cpu16 = _logits_along(_copy(model, cfg, "cpu", d), prompt, toks, src)[0]
        flips16 += _route_flips(routes, own)
        if d == d32:
            with _routes() as routes:
                card32 = _logits_along(_copy(model, cfg32, model.device, d), prompt, toks, src)[0]
            with _routes(routes) as own:
                cpu32 = _logits_along(_copy(model, cfg32, "cpu", d), prompt, toks, src)[0]
            flips32 = _route_flips(routes, own)
            e32 = _rel_errs(card32, cpu32)
        else:
            cpu32 = _logits_along(_copy(model, cfg32, "cpu", d), prompt, toks, src)[0]
        e16[d], spread[d] = max(_rel_errs(card, cpu16)), max(_rel_errs(cpu16, cpu32))
    ctx = "" if src is None else f", context {tuple(src.shape)}"
    moe = "" if not cfg.moe_experts else (
        f"; the CPU ran the card's expert choices, its own differ in float32 for "
        f"{_flips_text(flips32)} (margin limit {ROUTE_TIE_F32}), in bfloat16 for "
        f"{_flips_text(flips16)}")
    log(f"[serve] {cfg.name}: card vs CPU (same port, weights copied), prompt "
        f"{CPU_CHECK_PROMPT} + {CPU_CHECK_STEPS} decode steps{ctx}, relative max logit error: "
        f"float32 compute, {d32} of {full} layers, per step {e32} (limit 1e-3); bfloat16 by "
        f"depth (layers: max over steps) {e16} (limit {BF16_LOGIT_TOL} at {witness} layers); "
        f"the CPU's own bfloat16 vs float32 spread by depth {spread}{moe}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not max(e32) < 1e-3:
        raise AssertionError(f"{cfg.name}: float32 card and CPU logits differ by {max(e32)!r}")
    if not e16[witness] < BF16_LOGIT_TOL:
        raise AssertionError(f"{cfg.name}: bfloat16 card and CPU logits differ by "
                             f"{e16[witness]!r} at {witness} layers")
    if not all(m < ROUTE_TIE_F32 for m, _ in flips32):
        raise AssertionError(f"{cfg.name}: float32 card and CPU chose other experts at "
                             f"(margin, delta) {flips32}")
    return {"bf16": e16[witness], "bf16_depth": witness, "f32": max(e32), "f32_depth": d32,
            "route_flips": (len(flips32), len(flips16))}


def _free() -> None:
    """Return the last phase's model and caches to the card before the next."""
    gc.collect()
    torch.cuda.empty_cache()


def _profile_decode(model, caches, B: int, n_ticks: int = 4) -> dict | None:
    """Device time by kernel over a few decode ticks at full occupancy
    (every lane at position ``SERVE_MAX_SEQ // 2``), from ``torch.profiler``.
    Only the kernel rows are summed: an operator's row repeats the time of
    the kernels it launched.  Returns the wall and device-busy ms per tick
    (None when the profiler saw no kernel time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.lm import lm_decode

    tok = torch.zeros(B, dtype=torch.int64, device=model.device)
    pos = np.full(B, SERVE_MAX_SEQ // 2)
    lm_decode(model, caches, tok, pos)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            lm_decode(model, caches, tok, pos)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    if not rows:
        log(f"[serve] {model.cfg.name}: profiler saw no kernel time over {n_ticks} decode ticks "
            f"({wall * 1e3:.3f} ms wall): device busy share not measured")
        return None
    log(f"[serve] {model.cfg.name}: profiler over {n_ticks} decode ticks (B={B}, position "
        f"{SERVE_MAX_SEQ // 2}): wall {wall * 1e3:.3f} ms, kernels {sum(r[2] for r in rows)} "
        f"launches, device busy {busy_us / 1e3:.3f} ms ({busy_us / 1e6 / wall:.1%}; idle "
        f"{1 - busy_us / 1e6 / wall:.1%}); top kernels by device time: "
        + "; ".join(f"{k[:60]} {t / 1e3:.3f} ms ({t / busy_us:.1%}) x{c}" for k, t, c in rows[:6]))
    return {"wall_ms": wall * 1e3 / n_ticks, "busy_ms": busy_us / 1e3 / n_ticks}


def _dense_expert_bound(cfg) -> tuple[float, float]:
    """(bytes, ms): the expert weights one decode tick reads under the
    reference's dense dispatch (every expert of every MoE layer, for any
    number of routed tokens) over the card's memory rate."""
    n_moe = cfg.n_periods * len(cfg.moe_positions)
    esize = torch.finfo(getattr(torch, cfg.compute_dtype)).bits // 8
    nbytes = n_moe * cfg.moe_experts * 3 * cfg.d_model * cfg.expert_d_ff * esize
    return nbytes, nbytes / PEAK_BYTES_PER_S * 1e3


def phase_serve(device, arch: str) -> dict:
    """Slice 3's path for one model, once, through the ContinuousBatcher."""
    from repro_torch.core.cfa.obs import TraceRecorder
    from repro_torch.kernels.block_attention import decode_attention
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.models.lm import init_lm
    from repro_torch.serve import scheduler
    from repro_torch.serve.scheduler import ContinuousBatcher, Request

    cfg = _serve_cfg(arch)
    t0 = time.perf_counter()
    model = init_lm(cfg, generator=torch.Generator(device).manual_seed(SEED), device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve] {arch} (tp=1): {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab} (padded {cfg.padded_vocab}), {n_params} parameters, init "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED)
    lens = _serve_prompt_lens(rng)
    reqs = [Request(i, rng.integers(0, cfg.vocab, size=int(n)), SERVE_MAX_NEW)
            for i, n in enumerate(lens)]
    rec = TraceRecorder(label=f"serve-{arch}")
    cb = ContinuousBatcher(model, lanes=SERVE_LANES, max_seq=SERVE_MAX_SEQ, recorder=rec)
    for r in reqs:
        cb.submit(r)

    finite, decode_positions = [], []

    def watch(fn, positions=None):
        def wrapped(*args, **kwargs):
            logits, caches = fn(*args, **kwargs)
            finite.append(torch.isfinite(logits).all())
            if positions is not None:
                positions.append(np.array(args[3]))
            return logits, caches
        return wrapped

    prefill_fn, decode_fn = scheduler.lm_prefill, scheduler.lm_decode
    scheduler.lm_prefill = watch(prefill_fn)
    scheduler.lm_decode = watch(decode_fn, decode_positions)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # earlier phases' results, the weights, the lanes
        decode_attention.launches = ssd_scan.launches = 0
        t0 = time.perf_counter()
        cb.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"decode_attention": decode_attention.launches,
                    "ssd_scan": ssd_scan.launches}
    finally:
        scheduler.lm_prefill, scheduler.lm_decode = prefill_fn, decode_fn
    peak = torch.cuda.max_memory_allocated()
    n_decode = len(decode_positions)
    n_attn = _self_attention_layers(cfg)
    n_mamba = cfg.period.count("mamba") * cfg.n_periods
    prefill_s = sum(s.dur for s in rec.find("admit", cat="serve"))
    decode_s = sum(s.dur for s in rec.find("step", cat="serve")) - prefill_s
    st = cb.stats()
    log(f"[serve] {arch}: {len(reqs)} requests (prompts {lens.tolist()}), {SERVE_LANES} lanes, "
        f"max_seq {SERVE_MAX_SEQ}: {wall:.3f} s wall; prefill {int(lens.sum())} tokens in "
        f"{prefill_s:.3f} s ({lens.sum() / prefill_s:.1f} tokens/s, admit spans); decode "
        f"{cb.tokens} tokens in {n_decode} ticks, {decode_s:.3f} s ({cb.tokens / decode_s:.1f} "
        f"tokens/s, step spans less admits); launches {launches}; max_memory_allocated "
        f"{peak / 2**30:.3f} GiB, of which {held / 2**30:.3f} GiB held before the run (weights, "
        f"lane caches, earlier phases' results)")
    log(f"[serve] {arch}: stats() {st}")
    if not all(r.done and len(r.out) == SERVE_MAX_NEW for r in reqs):
        raise AssertionError(f"{arch}: not every request finished with {SERVE_MAX_NEW} tokens")
    if not all(bool(f) for f in finite):
        raise AssertionError(f"{arch}: non-finite logits on the serve path")
    if n_decode != cb.ticks or launches["decode_attention"] != n_attn * n_decode:
        raise AssertionError(f"{arch}: {launches['decode_attention']} decode_attention launches "
                             f"for {n_decode} decode ticks x {n_attn} attention layers")
    if launches["ssd_scan"] != n_mamba * len(reqs):
        raise AssertionError(f"{arch}: {launches['ssd_scan']} ssd_scan launches for "
                             f"{len(reqs)} prefills x {n_mamba} mamba layers")
    err = _cpu_check(model, cfg, rng)
    tick = _profile_decode(model, cb.caches, cb.lanes)
    if cfg.moe_experts:
        nbytes, bound = _dense_expert_bound(cfg)
        window = ("not measured" if tick is None else
                  f"{tick['wall_ms']:.3f} ms wall, device busy {tick['busy_ms']:.3f} ms")
        log(f"[serve] {arch}: decode tick against the dense-expert bound: the reference's dense "
            f"dispatch reads every expert's weights each tick, {nbytes} B "
            f"({nbytes / 1e9:.2f} GB) / {PEAK_BYTES_PER_S / 1e12:.2f} TB/s = {bound:.3f} ms; "
            f"measured per tick {decode_s / n_decode * 1e3:.3f} ms (serve stream, host clock), "
            f"profiled window per tick {window}")
    mid = decode_positions[n_decode // 2] + 1  # the valid prefix of a mid-run tick
    return {"launches": launches, "decode_lengths": mid, "cpu_err": err,
            "prompt_lens": lens, "ticks": n_decode}


def _self_attention_layers(cfg) -> int:
    """Layers whose decode step runs ``decode_attention`` (``attn`` and the
    decoder's ``dec``; a ``cross`` layer reads its context in plain PyTorch)."""
    return (cfg.period.count("attn") + cfg.period.count("dec")) * cfg.n_periods


def phase_serve_ctx(device, arch: str) -> dict:
    """Slice 8's context paths, as a user runs them: ``python -m
    repro_torch.launch.serve`` (its ``main``) at full width and depth with
    batch ``CTX_BATCH``, prompts of ``CTX_PROMPT`` tokens, ``CTX_GEN`` new
    tokens, ``--seed 0``; then the card-vs-CPU check at a full-width cut."""
    from repro_torch.kernels.block_attention import decode_attention
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.launch import serve as launcher
    from repro_torch.models.lm import init_lm

    cfg = _serve_cfg(arch)
    batch, prompt, gen = CTX_BATCH, CTX_PROMPT, CTX_GEN
    argv = ["--arch", arch, "--batch", str(batch), "--prompt-len", str(prompt), "--gen", str(gen),
            "--seed", str(SEED)]
    finite, n_decode = [], [0]

    def watch(fn, counts: bool):
        def wrapped(*args, **kwargs):
            logits, caches = fn(*args, **kwargs)
            finite.append(torch.isfinite(logits).all())
            n_decode[0] += counts
            return logits, caches
        return wrapped

    log(f"[serve-ctx] {arch} (tp=1): {cfg.n_layers} layers ({cfg.period} x {cfg.n_periods}), "
        f"{cfg.enc_layers} encoder layers, d_model {cfg.d_model}, context "
        f"{cfg.n_context_tokens} x {cfg.d_model}, {cfg.param_count()} parameters (analytic); "
        f"launcher argv {argv}")
    prefill_fn, decode_fn = launcher.lm_prefill, launcher.lm_decode
    launcher.lm_prefill, launcher.lm_decode = watch(prefill_fn, False), watch(decode_fn, True)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        decode_attention.launches = ssd_scan.launches = 0
        t0 = time.perf_counter()
        out = launcher.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"decode_attention": decode_attention.launches,
                    "ssd_scan": ssd_scan.launches}
    finally:
        launcher.lm_prefill, launcher.lm_decode = prefill_fn, decode_fn
    peak = torch.cuda.max_memory_allocated()
    _free()
    n_self = _self_attention_layers(cfg)
    log(f"[serve-ctx] {arch}: {wall:.3f} s wall (init included); prefill {batch}x{prompt} "
        f"tokens in {out['prefill_s']:.3f} s ({batch * prompt / out['prefill_s']:.1f} tokens/s); "
        f"decode {batch}x{gen} tokens in {out['decode_s']:.3f} s "
        f"({batch * gen / out['decode_s']:.1f} tokens/s, {n_decode[0]} lm_decode steps); "
        f"launches {launches}; max_memory_allocated {peak / 2**30:.3f} GiB, of which "
        f"{held / 2**30:.3f} GiB held before the run")
    if out["tokens"].shape != (batch, gen) or not all(bool(f) for f in finite):
        raise AssertionError(f"{arch}: tokens {out['tokens'].shape} or non-finite logits")
    if n_decode[0] != gen - 1 or launches["decode_attention"] != n_self * (gen - 1):
        raise AssertionError(f"{arch}: {launches['decode_attention']} decode_attention launches "
                             f"for {n_decode[0]} decode steps x {n_self} self-attention layers")
    if launches["ssd_scan"]:
        raise AssertionError(f"{arch}: ssd_scan launched {launches['ssd_scan']} times")
    depth = CPU_CHECK[arch][2]
    cut = dataclasses.replace(cfg, n_layers=depth, enc_layers=min(cfg.enc_layers, depth))
    model = init_lm(cut, generator=torch.Generator(device).manual_seed(SEED), device=device)
    with torch.no_grad():
        for block in model.layers:
            if block.kind == "cross":
                block.gate.fill_(CHECK_GATE)
    err = _cpu_check(model, cut, np.random.default_rng(SEED))
    del model
    _free()
    return {"launches": launches, "decode_steps": n_decode[0], "cpu_err": err}


def phase_jamba_smoke(device) -> dict:
    """jamba's SMOKE config (attention, Mamba and MoE layers) through the
    ``ContinuousBatcher`` on the card, in the served bfloat16; every
    prefill, splice and decode call it made is then replayed on the CPU with
    the weights copied over and the card's tokens and expert choices fed,
    and each call's logits are held to the card's within 0.06 relative (the
    CPU's own expert choices are printed beside the card's; see
    ``ROUTE_TIE_F32``).
    Then ``_cpu_check`` on the same weights: float32 compute and caches
    within 1e-3, bfloat16 within 0.06.  (A float32-compute batcher keeps
    bfloat16 caches, whose values the card and the CPU round apart at
    midpoints; through seven Mamba layers' conv tails and states those
    differences compound over the decode steps.)"""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.block_attention import decode_attention
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.models.lm import init_caches, init_lm, lm_decode, lm_prefill
    from repro_torch.serve import scheduler
    from repro_torch.serve.scheduler import ContinuousBatcher, Request

    cfg = get_smoke_config(JAMBA)
    model = init_lm(cfg, generator=torch.Generator(device).manual_seed(SEED), device=device)
    rng = np.random.default_rng(SEED)
    lens = rng.integers(JAMBA_PROMPTS[0], JAMBA_PROMPTS[1] + 1, size=JAMBA_REQUESTS)
    reqs = [Request(i, rng.integers(0, cfg.vocab, size=int(n)), JAMBA_MAX_NEW)
            for i, n in enumerate(lens)]
    calls = []
    prefill_fn, decode_fn, splice_fn = scheduler.lm_prefill, scheduler.lm_decode, scheduler._splice

    def prefill(m, prompt, **kw):
        logits, caches = prefill_fn(m, prompt, **kw)
        calls.append(("prefill", prompt.cpu().clone(), logits.float().cpu()))
        return logits, caches

    def decode(m, caches, token, position):
        logits, caches = decode_fn(m, caches, token, position)
        # copies: the batcher's token and position arrays change in place
        calls.append(("decode", torch.as_tensor(token).cpu().clone(), np.array(position),
                      logits.float().cpu()))
        return logits, caches

    def splice(dst, lane, src):
        calls.append(("splice", lane))
        splice_fn(dst, lane, src)

    cb = ContinuousBatcher(model, lanes=JAMBA_LANES, max_seq=JAMBA_MAX_SEQ)
    for r in reqs:
        cb.submit(r)
    scheduler.lm_prefill, scheduler.lm_decode, scheduler._splice = prefill, decode, splice
    try:
        torch.cuda.synchronize()
        decode_attention.launches = ssd_scan.launches = 0
        with _routes() as routes:
            cb.run()
        torch.cuda.synchronize()
        launches = {"decode_attention": decode_attention.launches,
                    "ssd_scan": ssd_scan.launches}
    finally:
        scheduler.lm_prefill, scheduler.lm_decode, scheduler._splice = (prefill_fn, decode_fn,
                                                                        splice_fn)
    cpu = _copy(model, cfg, "cpu", cfg.n_layers)
    caches, pending = init_caches(cfg, JAMBA_LANES, JAMBA_MAX_SEQ, device="cpu"), None
    prefill_errs, decode_errs = [], []
    with _routes(routes) as own:
        for call in calls:
            if call[0] == "prefill":
                logits, pending = lm_prefill(cpu, call[1], max_seq=JAMBA_MAX_SEQ)
                prefill_errs += _rel_errs([call[2]], [logits.float()])
            elif call[0] == "splice":
                splice_fn(caches, call[1], pending)
            else:
                logits, _ = lm_decode(cpu, caches, call[1], call[2])
                decode_errs += _rel_errs([call[3]], [logits.float()])
    flips = _route_flips(routes, own)
    errs = prefill_errs + decode_errs
    ticks = sum(c[0] == "decode" for c in calls)
    n_attn, n_mamba = _self_attention_layers(cfg), cfg.period.count("mamba") * cfg.n_periods
    log(f"[jamba-smoke] {cfg.name} SMOKE ({cfg.n_layers} layers {cfg.period}, MoE at "
        f"{cfg.moe_positions}, {cfg.moe_experts} experts top-{cfg.moe_top_k}, d_model "
        f"{cfg.d_model}), {cfg.compute_dtype} compute: {len(reqs)} requests (prompts "
        f"{lens.tolist()}), {JAMBA_LANES} lanes, max_seq {JAMBA_MAX_SEQ}, {JAMBA_MAX_NEW} new "
        f"each: {ticks} decode ticks, launches {launches}; card vs CPU replay of its "
        f"{len(errs)} prefill/decode calls (the card's expert choices), relative max logit "
        f"error {max(errs)!r} (limit {BF16_LOGIT_TOL}; prefills {max(prefill_errs)!r}, the "
        f"decode ticks in order, every 5th: {[round(e, 6) for e in decode_errs[::5]]}); "
        f"the CPU's own expert choices differ for {_flips_text(flips)}")
    err = _cpu_check(model, cfg, rng)
    del model, cb, cpu
    _free()
    if not all(r.done and len(r.out) == JAMBA_MAX_NEW for r in reqs):
        raise AssertionError(f"jamba SMOKE: not every request finished with {JAMBA_MAX_NEW} tokens")
    if launches["decode_attention"] != n_attn * ticks:
        raise AssertionError(f"jamba SMOKE: {launches['decode_attention']} decode_attention "
                             f"launches for {ticks} ticks x {n_attn} attention layers")
    if launches["ssd_scan"] != n_mamba * len(reqs):
        raise AssertionError(f"jamba SMOKE: {launches['ssd_scan']} ssd_scan launches for "
                             f"{len(reqs)} prefills x {n_mamba} mamba layers")
    if not max(errs) < BF16_LOGIT_TOL:
        raise AssertionError(f"jamba SMOKE: card and CPU logits differ by {max(errs)!r}")
    return {"launches": launches, "ticks": ticks, "err": max(errs), "cpu_err": err}


# -- slice 9: training ----------------------------------------------------------


def _train_cfg(**kw):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(TRAIN_ARCH), tp=1, **kw)


def _train_hp(steps: int = TRAIN_STEPS):
    """The hyper-parameters ``launch.train`` derives from ``--steps``."""
    from repro_torch.train.steps import TrainHParams

    return TrainHParams(total_steps=max(steps, 10), warmup=min(20, steps))


def _losses(log: list[dict]) -> dict[int, float]:
    return {m["step"]: m["loss"] for m in log}


def _profile_step(trainer, batch: dict, tag: str = "[train]") -> dict | None:
    """Wall and device-busy seconds of one train step (kernel rows only),
    under the trainer's mesh; the collectives' rows (NCCL kernels and
    device-to-device copies) summed apart."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.distributed.sharding import use_mesh

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            use_mesh(getattr(trainer, "mesh", None)):
        t0 = time.perf_counter()
        trainer.step_fn(trainer.model, trainer.opt_state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    if not rows:
        log(f"{tag} profiler saw no kernel time over one step ({wall:.3f} s wall): device "
            f"busy share not measured")
        return None
    busy = sum(r[1] for r in rows) / 1e6
    log(f"{tag} profiler over one step: wall {wall * 1e3:.3f} ms, kernels "
        f"{sum(r[2] for r in rows)} launches, device busy {busy * 1e3:.3f} ms ({busy / wall:.1%};"
        f" idle {1 - busy / wall:.1%}); top kernels by device time: "
        + "; ".join(f"{k[:60]} {t / 1e3:.3f} ms ({t / 1e6 / busy:.1%}) x{c}"
                    for k, t, c in rows[:8]))
    bwd = [(_kernel_name(k), t, c) for k, t, c in rows
           if _kernel_name(k).startswith(SSD_BWD_KERNELS)]
    bwd_s = sum(t for _, t, _ in bwd) / 1e6
    log(f"{tag} ssd_scan_bwd over the step: {bwd_s * 1e3:.3f} ms of device time "
        f"({bwd_s / busy:.1%} of the busy time): "
        + ", ".join(f"{k} {t / 1e3:.3f} ms x{c}" for k, t, c in bwd))
    comm = [(k, t, c) for k, t, c in rows if "nccl" in k.lower() or "dtod" in k.lower()]
    comm_s = sum(t for _, t, _ in comm) / 1e6
    calls = {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CPU
             and any(w in e.key.lower() for w in ("all_gather", "reduce_scatter", "all_reduce",
                                                  "allgather", "allreduce"))}
    log(f"{tag} collectives and device copies over the step: {comm_s * 1e3:.3f} ms of device "
        f"time ({comm_s / busy:.2%} of the busy time) in {sum(c for _, _, c in comm)} launches"
        + ("" if not comm else ": " + "; ".join(f"{k[:60]} {t / 1e3:.3f} ms x{c}"
                                                for k, t, c in comm[:6]))
        + f"; host-side collective calls: {calls}")
    return {"wall_s": wall, "busy_s": busy, "comm_s": comm_s, "calls": calls}


def _grads_cpu_check(device, cfg, seq: int, tag: str) -> dict:
    """Card vs CPU: the loss and every gradient leaf of ``cfg`` (a full-width
    cut in float32 compute; batch 1, ``seq`` tokens, remat on), the card's
    weights copied to the CPU."""
    from repro_torch.interop import lm_from_numpy, lm_to_numpy
    from repro_torch.models.lm import init_lm, param_leaves
    from repro_torch.train.steps import TrainHParams, loss_fn

    card = init_lm(cfg, generator=torch.Generator(device).manual_seed(SEED), device=device,
                   dtype=cfg.param_dtype)
    host = lm_from_numpy(cfg, lm_to_numpy(card), device="cpu", dtype=cfg.param_dtype)
    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab, size=(1, seq))
    hp = TrainHParams(remat=True)
    out = {}
    for name, model in (("card", card), ("cpu", host)):
        loss, _ = loss_fn(model, {"tokens": torch.as_tensor(tokens, device=model.device)}, cfg,
                          hp)
        loss.backward()
        out[name] = (float(loss.detach()), [leaf.take_grad().cpu() for leaf in param_leaves(model)])
    rel_loss = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    worst, worst_leaf = 0.0, None
    for leaf, g, w in zip(param_leaves(host), out["card"][1], out["cpu"][1]):
        ex = _excess(g, w, (0.0, TRAIN_GRAD_TOL[0] * float(w.abs().max()) + TRAIN_GRAD_TOL[1]))
        if ex >= worst:
            worst, worst_leaf = ex, "/".join(leaf.path)
    log(f"{tag} card vs CPU gradients, {cfg.name} cut to {cfg.n_layers} layers at full "
        f"width (batch 1, seq {seq}, float32 compute, remat): loss {out['card'][0]!r} "
        f"vs {out['cpu'][0]!r} (relative {rel_loss:.3e}, limit 1e-4); the worst of "
        f"{len(out['cpu'][1])} gradient leaves {worst:.3f} x the limit (1e-3 max|g_cpu| + 1e-6) "
        f"at {worst_leaf}")
    if not (rel_loss <= 1e-4 and worst <= 1.0):
        raise AssertionError(f"card and CPU gradients differ: loss {rel_loss:.3e}, leaf {worst}")
    return {"rel_loss": rel_loss, "grad_excess": worst, "worst_leaf": worst_leaf}


def phase_train(device) -> dict:
    """Slice 9's path: mamba2-370m at full width and depth trains on the card
    (AdamW, remat, float32 master weights, bf16 compute) through
    ``repro_torch.launch.train.main`` as a user runs it — ``TRAIN_STEPS``
    steps into a checkpoint directory, then the same command again, which
    must resume and run as many more — against an uninterrupted ``Trainer``
    run from the same seed; then a fixed batch whose loss must fall, and the
    card-vs-CPU gradient check."""
    import tempfile

    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels.ssd import ssd_scan, ssd_scan_bwd
    from repro_torch.launch import train as launch_train
    from repro_torch.models.lm import param_leaves
    from repro_torch.train.loop import Trainer
    from repro_torch.train.steps import TrainHParams

    cfg = _train_cfg()
    root = Path(tempfile.mkdtemp(prefix="train_", dir=ROOT / "build"))
    steps = 2 * TRAIN_STEPS
    for batch in TRAIN_BATCHES:
        argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch", str(batch),
                "--seq", str(TRAIN_SEQ), "--ckpt-dir", str(root / f"b{batch}"),
                "--ckpt-every", str(TRAIN_STEPS), "--log-every", "1"]
        try:
            _free()
            torch.cuda.reset_peak_memory_stats()
            ssd_scan.launches = ssd_scan_bwd.launches = 0
            t0 = time.perf_counter()
            first = launch_train.main(argv)
            saved = [t.cpu() for t in first["trainer"].state()]
            del first["trainer"]
            second = launch_train.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"ssd_scan": ssd_scan.launches, "ssd_scan_bwd": ssd_scan_bwd.launches}
            break
        except torch.OutOfMemoryError as e:
            log(f"[train] batch {batch} x {TRAIN_SEQ} does not fit: {str(e).splitlines()[0][:120]}")
            first = second = None
            _free()
    else:
        raise AssertionError(f"no batch of {TRAIN_BATCHES} x {TRAIN_SEQ} fits the card")
    peak = torch.cuda.max_memory_allocated()
    n_mamba = sum(1 for _ in range(cfg.n_periods) for k in cfg.period if k == "mamba")
    tokens = batch * TRAIN_SEQ
    log(f"[train] {TRAIN_ARCH} ({cfg.n_layers} layers, d_model {cfg.d_model}, d_inner "
        f"{cfg.ssm_d_inner}, {cfg.ssm_heads} heads x {cfg.ssm_head_dim}, state {cfg.ssm_state}, "
        f"chunk {cfg.ssm_chunk}, vocab {cfg.vocab}) ran at batch {batch} x seq {TRAIN_SEQ} "
        f"(the largest of {TRAIN_BATCHES} that fits), AdamW, remat, float32 master weights, "
        f"bfloat16 compute: python -m repro_torch.launch.train {' '.join(argv)} twice, "
        f"{wall:.1f} s with both checkpoints")
    log(f"[train] first run resumed from {first['start']}: losses {_losses(first['log'])}; "
        f"second run resumed from {second['start']}: losses {_losses(second['log'])}")
    want_fwd, want_bwd = n_mamba * 2 * steps, n_mamba * steps
    log(f"[train] launches over the launcher's {steps} steps: ssd_scan {launches['ssd_scan']} "
        f"(want {n_mamba} x 2 x {steps} = {want_fwd}: forward and remat recompute), "
        f"ssd_scan_bwd {launches['ssd_scan_bwd']} (want {n_mamba} x {steps} = {want_bwd})")
    if first["start"] != 0 or second["start"] != TRAIN_STEPS or \
            sorted(_losses(second["log"])) != list(range(TRAIN_STEPS + 1, steps + 1)):
        raise AssertionError("the second launcher run did not resume at the checkpoint")
    if launches != {"ssd_scan": want_fwd, "ssd_scan_bwd": want_bwd}:
        raise AssertionError(f"launch counts {launches} != {want_fwd}, {want_bwd}")
    for m in first["log"] + second["log"]:
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"a non-finite loss or grad-norm: {m}")
    # the checkpoints: step TRAIN_STEPS as saved, the last one as a restart restores it
    resumed = second["trainer"]
    from_disk = resumed.ckpt.restore(TRAIN_STEPS, [t for t in saved])
    same_saved = all(bit_equal(a, b) for a, b in zip(from_disk, saved))
    hp = _train_hp()
    again = Trainer(cfg, batch=batch, seq=TRAIN_SEQ, ckpt_dir=resumed.ckpt.dir, hp=hp,
                    device=device)
    same_restored = again.step == steps and all(
        bit_equal(a, b) for a, b in zip(again.state(), resumed.state()))
    again.data.close()
    log(f"[train] checkpoints: step {TRAIN_STEPS} read back == the state saved, bit for bit: "
        f"{same_saved} ({len(saved)} leaves: {len(resumed.leaves)} parameter leaves, then "
        f"the optimizer's step, mu and nu); a restart restores step {steps} == the resumed "
        f"run's final parameters and moments bit for bit: {same_restored}")
    if not (same_saved and same_restored):
        raise AssertionError("a restored checkpoint differs from the saved state")
    del again, saved, from_disk
    _free()
    # the uninterrupted run from the same seed
    straight = Trainer(cfg, batch=batch, seq=TRAIN_SEQ, ckpt_dir=root / "straight", hp=hp,
                       ckpt_every=10 ** 9, device=device)
    log_s = straight.run(steps, log_every=1)
    straight.data.close()
    got, want = _losses(second["log"]), _losses(log_s)
    rel = max(abs(got[k] - want[k]) / abs(want[k]) for k in got)
    bit = all(got[k] == want[k] for k in got)
    same_state = all(bit_equal(a, b) for a, b in zip(straight.state(), resumed.state()))
    log(f"[train] uninterrupted Trainer run ({steps} steps, seed 0): losses {want}; steps "
        f"{TRAIN_STEPS + 1}-{steps} against the resumed run: bit-equal {bit}, max relative "
        f"difference {rel:.3e}; final parameters and moments bit-equal {same_state}")
    if not (bit or rel <= 1e-5):
        raise AssertionError(f"the resumed run's losses differ from the uninterrupted run's: "
                             f"{rel:.3e}")
    dts = [m["dt"] for m in log_s[1:]]
    step_s = statistics.median(dts)
    batch_t = {"tokens": torch.as_tensor(straight.data.batch_at(steps)["tokens"],
                                         device=device)}
    prof = _profile_step(straight, batch_t)
    n_params = sum(p.numel() for leaf in param_leaves(straight.model) for p in leaf.parts
                   if leaf.path[0] != "embed")
    mfu = 8 * n_params * tokens / step_s / PEAK_BF16_TC_FLOPS
    log(f"[train] median step {step_s * 1e3:.3f} ms over steps 2-{steps} of the uninterrupted "
        f"run ({tokens / step_s:.1f} tokens/s); peak memory {peak / 2 ** 30:.3f} GiB "
        f"(max_memory_allocated over the launcher's runs); model FLOPs 8 N tokens with remat, "
        f"N = {n_params} non-embedding parameters: {8 * n_params * tokens / 1e12:.3f} TFLOP per "
        f"step, {mfu:.2%} of the bf16 tensor-core peak 989 TFLOP/s")
    del straight, resumed, second
    _free()
    # a fixed batch the model can learn
    hp_fixed = TrainHParams(peak_lr=1e-3, warmup=2, total_steps=40)

    class Fixed(SyntheticTokens):
        def batch_at(self, step):
            rng = np.random.default_rng(42)  # the same batch every step
            return {"tokens": rng.integers(0, self.vocab, size=(self.batch, self.seq),
                                           dtype=np.int32)}

    fixed = Trainer(cfg, batch=batch, seq=TRAIN_SEQ, ckpt_dir=root / "fixed", hp=hp_fixed,
                    ckpt_every=10 ** 9, device=device,
                    data=Fixed(vocab=cfg.vocab, batch=batch, seq=TRAIN_SEQ))
    log_f = fixed.run(steps, log_every=1)
    fixed.data.close()
    lf = _losses(log_f)
    log(f"[train] fixed batch (peak lr 1e-3): losses {lf}")
    if not (all(math.isfinite(v) for v in lf.values()) and lf[steps] < lf[1]):
        raise AssertionError(f"the fixed batch's loss did not fall: {lf[1]} -> {lf[steps]}")
    del fixed
    _free()
    check = _grads_cpu_check(device, _train_cfg(n_layers=TRAIN_CPU_LAYERS,
                                                compute_dtype="float32"),
                             TRAIN_CPU_SEQ, "[train]")
    _free()
    return {"batch": batch, "launches": launches, "step_ms": step_s * 1e3,
            "tokens_per_s": tokens / step_s, "peak_gib": peak / 2 ** 30, "mfu": mfu,
            "busy": None if prof is None else prof["busy_s"] / prof["wall_s"], **check}


def phase_train_mesh(device, batch: int, smi: str) -> dict:
    """Slice 11's path: the training path on a world-1 ``DeviceMesh`` (an
    ``nccl`` group in this process over a ``FileStore`` under ``build/``).
    ``Trainer(mesh=mesh_for_devices())`` — parameters and moments DTensors,
    each layer's weights gathered where it reads them, the gradients
    reduce-scattered — runs mamba2-370m at full width and depth at
    ``[train]``'s batch x ``TRAIN_SEQ`` for ``TRAIN_MESH_STEPS`` steps, then an
    unmeshed ``Trainer`` from the same seed; their losses, grad norms,
    parameters and moments must be bit-equal, ``ssd_scan`` and
    ``ssd_scan_bwd`` must launch inside the meshed steps (layers x 2 x steps,
    layers x steps), and the meshed checkpoint restored with ``shardings=``
    must equal the saved state bit for bit; then ``python -m
    torch.distributed.run --standalone --nproc-per-node 1 -m
    repro_torch.launch.train`` in a child process must log the meshed run's
    losses.  No fallback: a group that cannot start fails the phase."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.distributed.sharding import full_tensor, use_mesh
    from repro_torch.kernels.ssd import ssd_scan, ssd_scan_bwd
    from repro_torch.launch.mesh import mesh_for_devices
    from repro_torch.train.loop import Trainer

    cfg, hp, steps = _train_cfg(), _train_hp(TRAIN_MESH_STEPS), TRAIN_MESH_STEPS
    n_mamba = sum(1 for _ in range(cfg.n_periods) for k in cfg.period if k == "mamba")
    root = Path(tempfile.mkdtemp(prefix="train_mesh_", dir=ROOT / "build"))
    dist.init_process_group("nccl", store=dist.FileStore(str(root / "store"), 1), rank=0,
                            world_size=1, device_id=device)
    try:
        mesh = mesh_for_devices()
        log(f"[train-mesh] {mesh} ({dist.get_backend()} group of {dist.get_world_size()}); "
            f"{TRAIN_ARCH} at batch {batch} x seq {TRAIN_SEQ}, {steps} steps per run, AdamW, "
            f"remat, seed {SEED}")
        runs = {}
        for name in ("meshed", "unmeshed"):
            _free()
            torch.cuda.reset_peak_memory_stats()
            ssd_scan.launches = ssd_scan_bwd.launches = 0
            trainer = Trainer(cfg, batch=batch, seq=TRAIN_SEQ, ckpt_dir=root / name, hp=hp,
                              mesh=mesh if name == "meshed" else None,
                              ckpt_every=steps if name == "meshed" else 10 ** 9, device=device)
            run_log = trainer.run(steps, log_every=1)
            torch.cuda.synchronize()
            run = {"log": run_log, "peak": torch.cuda.max_memory_allocated(),
                   "launches": {"ssd_scan": ssd_scan.launches,
                                "ssd_scan_bwd": ssd_scan_bwd.launches},
                   "step_ms": statistics.median(m["dt"] for m in run_log[1:]) * 1e3,
                   "state": [full_tensor(t).cpu() for t in trainer.state()]}
            if name == "meshed":
                placed = trainer.state()
                with use_mesh(mesh):
                    restored = trainer.ckpt.restore(steps, placed, shardings=trainer.shardings())
                run["ckpt_equal"] = all(
                    type(r) is type(t) and getattr(r, "placements", None) ==
                    getattr(t, "placements", None) and bit_equal(full_tensor(r).cpu(), w)
                    for r, t, w in zip(restored, placed, run["state"]))
                del placed, restored
                batch_t = {"tokens": torch.as_tensor(trainer.data.batch_at(steps)["tokens"],
                                                     device=device)}
                run["profile"] = _profile_step(trainer, batch_t, "[train-mesh]")
            trainer.data.close()
            runs[name] = run
            del trainer
        _free()
        meshed, plain = runs["meshed"], runs["unmeshed"]
        want = {"ssd_scan": n_mamba * 2 * steps, "ssd_scan_bwd": n_mamba * steps}
        same = {k: [m[k] for m in meshed["log"]] == [m[k] for m in plain["log"]]
                for k in ("loss", "grad_norm", "lr")}
        same_state = all(bit_equal(a, b) for a, b in zip(meshed["state"], plain["state"]))
        log(f"[train-mesh] meshed losses {_losses(meshed['log'])}, grad norms "
            f"{[m['grad_norm'] for m in meshed['log']]}; unmeshed losses "
            f"{_losses(plain['log'])}; bit-equal: {same}; every parameter and moment "
            f"({len(plain['state'])} tensors) bit-equal: {same_state}")
        log(f"[train-mesh] launches in the meshed run: ssd_scan {meshed['launches']['ssd_scan']} "
            f"(want {n_mamba} x 2 x {steps} = {want['ssd_scan']}), ssd_scan_bwd "
            f"{meshed['launches']['ssd_scan_bwd']} (want {n_mamba} x {steps} = "
            f"{want['ssd_scan_bwd']}); the unmeshed run's {plain['launches']}")
        log(f"[train-mesh] the meshed checkpoint of step {steps} restored with shardings= "
            f"(DTensors on the mesh) == the state it saved, bit for bit: {meshed['ckpt_equal']}")
        log(f"[train-mesh] step {steps} of {steps}: meshed {meshed['step_ms']:.3f} ms, unmeshed "
            f"{plain['step_ms']:.3f} ms (ratio {meshed['step_ms'] / plain['step_ms']:.4f}); "
            f"peak max_memory_allocated meshed {meshed['peak'] / 2 ** 30:.3f} GiB, unmeshed "
            f"{plain['peak'] / 2 ** 30:.3f} GiB; card: {smi}")
        if not (all(same.values()) and same_state):
            raise AssertionError("the meshed and unmeshed runs differ")
        if meshed["launches"] != want:
            raise AssertionError(f"meshed launches {meshed['launches']} != {want}")
        if not meshed["ckpt_equal"]:
            raise AssertionError("the meshed checkpoint restored with shardings= differs")
        # the launcher under torchrun, in a child process
        metrics = root / "launcher.json"
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "1", "-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH,
               "--steps", str(steps), "--batch", str(batch), "--seq", str(TRAIN_SEQ),
               "--ckpt-dir", str(root / "launcher"), "--ckpt-every", str(10 ** 9),
               "--log-every", "1", "--metrics-out", str(metrics)]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"the torchrun launcher failed ({res.returncode}):\n"
                                 f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        child = json.loads(metrics.read_text())
        log(f"[train-mesh] python -m torch.distributed.run --standalone --nproc-per-node 1 -m "
            f"repro_torch.launch.train {' '.join(cmd[8:])}: {wall:.1f} s; losses "
            f"{_losses(child)}; output: {res.stdout.strip().splitlines()[-1]}")
        if _losses(child) != _losses(meshed["log"]):
            raise AssertionError(f"the launcher's losses {_losses(child)} != the meshed run's "
                                 f"{_losses(meshed['log'])}")
    finally:
        dist.destroy_process_group()
    prof = meshed["profile"]
    return {"launches": meshed["launches"], "step_ms": meshed["step_ms"],
            "plain_step_ms": plain["step_ms"], "peak_gib": meshed["peak"] / 2 ** 30,
            "plain_peak_gib": plain["peak"] / 2 ** 30,
            "comm_share": None if prof is None else prof["comm_s"] / prof["busy_s"]}


def _pipe_cfg():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(PIPE_ARCH), tp=1)


def _pipe_block(cfg, stage: int, device):
    """Stage ``stage``'s deepseek-67b block: bf16 weights drawn from a CUDA
    generator seeded ``SEED + stage`` (the same in the parent and the rank)."""
    from repro_torch.models.blocks import ffn_kind, init_position

    gen = torch.Generator(device).manual_seed(SEED + stage)
    with torch.no_grad():
        return init_position("attn", ffn_kind(cfg, 0), cfg, generator=gen, device=device)


def _pipe_input(cfg, device) -> torch.Tensor:
    """(M, 1, PIPE_SEQ, d_model) bf16 microbatches, seeded."""
    gen = torch.Generator(device).manual_seed(SEED + 100)
    return torch.randn((PIPE_MICRO, 1, PIPE_SEQ, cfg.d_model), generator=gen,
                       device=device).to(torch.bfloat16)


def _pipe_forward(block, h: torch.Tensor) -> torch.Tensor:
    """The port's block forward in training mode, with no cache."""
    from repro_torch.models.blocks import apply_position

    ctx = {"positions": torch.arange(h.shape[1], device=h.device)[None, :], "cross_src": None,
           "dp_groups": ()}
    return apply_position(block, h, "train", None, ctx)[0]


def _pipe_stage_fn(block):
    """The stage function ``pipeline_apply`` calls: ``_pipe_forward`` with
    ``block``'s parameters replaced by the stage's rows of the pipeline's
    stage parameters (``torch.func.functional_call``)."""
    from torch.func import functional_call

    class _Stage(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.block = block

        def forward(self, h):
            return _pipe_forward(self.block, h)

    stage = _Stage()
    return lambda local, h: functional_call(stage, {f"block.{k}": v for k, v in local.items()},
                                            (h,))


def _pipe_rank(out_dir: str) -> int:
    """One rank of ``[pipeline]``'s child (``python -m torch.distributed.run
    --nproc-per-node 4 chip_smoke.py --pipeline-rank DIR``): a gloo group,
    a ("pipe",) mesh of 4 over the one card, this rank's block held as
    DTensors ``Shard(0)`` over ``pipe`` (local leading dim 1), then
    ``pipeline_apply`` twice (the second timed); writes its output's hash,
    its walls and, on rank 0, the output."""
    import hashlib

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.distributed.pipeline import pipeline_apply

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group("gloo")
    rank = dist.get_rank()
    try:
        mesh = init_device_mesh("cuda", (dist.get_world_size(),), mesh_dim_names=("pipe",))
        cfg = _pipe_cfg()
        block = _pipe_block(cfg, rank, device)
        params = {name: DTensor.from_local(p.detach()[None], mesh, [Shard(0)], run_check=False)
                  for name, p in block.named_parameters()}
        x = _pipe_input(cfg, device)
        stage = _pipe_stage_fn(block)
        walls = []
        with torch.no_grad():
            for _ in range(2):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = pipeline_apply(stage, params, x, mesh)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        host = out.cpu()
        digest = hashlib.sha256(host.view(torch.int16).numpy().tobytes()).hexdigest()
        if rank == 0:
            torch.save(host, Path(out_dir) / "out.pt")
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(
            {"sha256": digest, "walls": walls, "finite": bool(torch.isfinite(out).all()),
             "shape": list(out.shape), "peak": torch.cuda.max_memory_allocated()}))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def phase_pipeline(device, smi: str) -> dict:
    """Slice 12's GPipe path: ``pipeline_apply`` over 4 gloo ranks on the one
    card (NCCL refuses two ranks on one GPU, gloo sends CPU tensors only:
    each tick's activations are staged through the host), each rank one
    full-width deepseek-67b block (depth cut to 4 of 95 layers) held only by
    that rank, ``PIPE_MICRO`` microbatches of 1 x ``PIPE_SEQ`` tokens.  The
    returned tensor must be the same on every rank and equal, bit for bit, a
    sequential run of the same four blocks in this process on the card
    (freed before the child starts).  Prints both walls (the four ranks
    share the card's SMs: the pipelined wall says nothing of a pipeline's
    speed-up), the bubble fraction and the bytes staged per tick."""
    import tempfile

    cfg = _pipe_cfg()
    x = _pipe_input(cfg, device)
    blocks = [_pipe_block(cfg, s, device) for s in range(PIPE_STAGES)]
    n_params = sum(p.numel() for p in blocks[0].parameters())
    walls = []
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = torch.stack([_sequential(blocks, x[m]) for m in range(PIPE_MICRO)])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    want = want.cpu()
    del blocks
    _free()
    log(f"[pipeline] {PIPE_ARCH} blocks at the published widths (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}, bf16), "
        f"{n_params / 1e9:.3f} B parameters and {n_params * 2 / 1e9:.3f} GB a stage; depth cut "
        f"to {PIPE_STAGES} of {cfg.n_layers} layers, one per stage; {PIPE_MICRO} microbatches "
        f"of 1 x {PIPE_SEQ} tokens; sequential run on the card {walls[1]:.3f} s "
        f"(first {walls[0]:.3f} s)")
    root = Path(tempfile.mkdtemp(prefix="pipeline_", dir=ROOT / "build"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(PIPE_STAGES), str(ROOT / "chip_smoke.py"), "--pipeline-rank", str(root)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=900)
    child_wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"the pipeline child failed ({res.returncode}):\n"
                             f"{res.stdout[-2000:]}\n{res.stderr[-6000:]}")
    ranks = [json.loads((root / f"rank{r}.json").read_text()) for r in range(PIPE_STAGES)]
    got = torch.load(root / "out.pt")
    same = len({r["sha256"] for r in ranks}) == 1
    equal = bit_equal(got, want)
    diff = max_abs(got, want)
    wall = max(r["walls"][1] for r in ranks)
    ticks = PIPE_MICRO + PIPE_STAGES - 1
    staged = PIPE_SEQ * cfg.d_model * 2
    log(f"[pipeline] python -m torch.distributed.run --nproc-per-node {PIPE_STAGES} (gloo, "
        f"one card): {child_wall:.1f} s in all; pipeline_apply {wall:.3f} s (first call "
        f"{max(r['walls'][0] for r in ranks):.3f} s), sequential {walls[1]:.3f} s (ratio "
        f"{wall / walls[1]:.3f}); {ticks} ticks, bubble (S-1)/(M+S-1) = "
        f"{PIPE_STAGES - 1}/{ticks} = {(PIPE_STAGES - 1) / ticks:.4f}; per tick each rank "
        f"stages {staged} bytes device->host and {staged} host->device (its send and receive); "
        f"peak max_memory_allocated per rank "
        f"{max(r['peak'] for r in ranks) / 2 ** 30:.3f} GiB; card: {smi}")
    log(f"[pipeline] output {tuple(got.shape)} {got.dtype}: the same on every rank (sha256): "
        f"{same}; equal to the sequential run bit for bit: {equal} (max abs diff {diff}); "
        f"finite: {all(r['finite'] for r in ranks)}")
    if not (same and equal and all(r["finite"] for r in ranks)):
        raise AssertionError("the pipelined run differs between ranks or from the sequential run")
    return {"wall": wall, "sequential": walls[1], "staged": staged, "ticks": ticks}


def _sequential(blocks, h: torch.Tensor) -> torch.Tensor:
    """``h`` through ``blocks`` in order (the sequential run)."""
    for block in blocks:
        h = _pipe_forward(block, h)
    return h


def phase_tools(device) -> dict:
    """Slice 12's CLIs on the card, each through the ``main`` that ``python
    -m repro_torch.tools.<name>`` runs: ``cfa_trace --validate`` on the
    kernel backend (stencil launches = waves) and on the dataflow backend
    (the plain version per tile: no launch), ``cfa_lint --json`` on
    the card equal to the same run on ``--device cpu``, ``dump_pipeline
    --verify`` (2 ports, ``sharded``), then ``stencil_tile_op`` with
    ``use_kernel=True`` against ``use_kernel=False`` on the card for every
    program: difference 0, one launch per call."""
    import contextlib as _ctx
    import io
    import tempfile

    from repro_torch.core.cfa.programs import get_program
    from repro_torch.kernels.stencil import execute_tiles, stencil_tile_op
    from repro_torch.tools import cfa_lint, cfa_trace, dump_pipeline

    def run(main, argv) -> tuple[int, str, str]:
        out, err = io.StringIO(), io.StringIO()
        with _ctx.redirect_stdout(out), _ctx.redirect_stderr(err):
            code = main(argv)
        return code, out.getvalue(), err.getvalue()

    root = Path(tempfile.mkdtemp(prefix="tools_", dir=ROOT / "build"))
    traced = {}
    for backend, space in (("cuda", TOOLS_SPACE), ("dataflow", TOOLS_DATAFLOW_SPACE)):
        argv = ["jacobi2d5p", *map(str, space), "--layout", ",".join(map(str, TOOLS_TILE)),
                "--backend", backend, "--validate", "--summary", "-o",
                str(root / f"{backend}.json")]
        torch.cuda.synchronize()
        execute_tiles.launches = 0
        t0 = time.perf_counter()
        code, _, err = run(cfa_trace.main, argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = execute_tiles.launches
        counters = json.loads(err.split("counters=", 1)[1].splitlines()[0]) \
            if "counters=" in err else {}
        size = (root / f"{backend}.json").stat().st_size
        log(f"[tools] python -m repro_torch.tools.cfa_trace {' '.join(argv[:-2])} -o "
            f"{backend}.json: exit {code}, {wall:.2f} s, {size} bytes of trace, "
            f"{counters.get('tiles')} tiles in {counters.get('waves')} waves, {launches} "
            f"stencil_tiles launches; {err.strip().splitlines()[-1] if err.strip() else ''}")
        want = counters.get("waves") if backend == "cuda" else 0
        if code != 0 or "validated: schema ok" not in err or launches != want:
            raise AssertionError(f"cfa_trace --backend {backend} failed (exit {code}, "
                                 f"{launches} launches, want {want}):\n{err[-3000:]}")
        traced[backend] = {"launches": launches, "counters": counters, "wall": wall}
    t0 = time.perf_counter()
    card = run(cfa_lint.main, ["--json", "--include-baselines"])
    t1 = time.perf_counter()
    cpu = run(cfa_lint.main, ["--json", "--include-baselines", "--device", "cpu"])
    doc = json.loads(card[1])
    log(f"[tools] cfa_lint --json --include-baselines: exit {card[0]} on the card "
        f"({t1 - t0:.1f} s), {cpu[0]} on --device cpu; {len(doc['entries'])} entries, max "
        f"severity {doc['max_severity']}; findings equal: {card[1] == cpu[1]}")
    if card[0] != cpu[0] or card[1] != cpu[1]:
        raise AssertionError("cfa_lint's findings on the card differ from --device cpu")
    code, out, _ = run(dump_pipeline.main, ["jacobi2d5p", "8", "8", "8", "--layout", "4,4,4",
                                            "--host-budget", "2000", "--verify"])
    dumped = json.loads(out)
    errors = [d for d in dumped["analysis"]["diagnostics"] if d["severity"] == "ERROR"]
    log(f"[tools] dump_pipeline jacobi2d5p 8 8 8 --layout 4,4,4 --host-budget 2000 --verify: "
        f"exit {code}; passes {[p['pass'] for p in dumped['passes']]}; compiled "
        f"{dumped['compiled']}; {len(dumped['analysis']['diagnostics'])} diagnostics, "
        f"{len(errors)} ERROR")
    want = {"n_ports": 2, "distributed": True, "backend": "sharded"}
    if code != 0 or errors or {k: dumped["compiled"][k] for k in want} != want:
        raise AssertionError(f"dump_pipeline: exit {code}, {dumped['compiled']}, {errors}")
    rng = np.random.default_rng(SEED)
    worst = 0.0
    execute_tiles.launches = 0
    for name, tile, batch in KERNEL_CASES:
        w = get_program(name).widths
        halos = rng_tensor(rng, (batch, *(a + b for a, b in zip(w, tile))), torch.float32,
                           device)
        got = stencil_tile_op(name, halos, tile, use_kernel=True)
        plain = stencil_tile_op(name, halos, tile, use_kernel=False)
        if not bit_equal(got, plain):
            raise AssertionError(f"stencil_tile_op {name} {tile}: kernel != plain version")
        worst = max(worst, max_abs(got, plain))
    log(f"[tools] stencil_tile_op(use_kernel=True) vs use_kernel=False on the card, "
        f"{len(KERNEL_CASES)} programs/shapes: max abs diff {worst}; "
        f"{execute_tiles.launches} launches (one per call)")
    if execute_tiles.launches != len(KERNEL_CASES):
        raise AssertionError(f"{execute_tiles.launches} launches for {len(KERNEL_CASES)} calls")
    return {"traced": traced, "worst": worst}


# -- slice 13: the examples ------------------------------------------------------


class _Example:
    """``python -m repro_torch.examples.<name> *argv`` started as a child
    with no ``--device`` (so on the card), its output in ``out_dir``."""

    def __init__(self, name: str, argv=(), *, out_dir: Path, tag: str | None = None):
        self.name, self.argv, self.tag = name, list(argv), tag or name
        self.out, self.err = out_dir / f"{self.tag}.out", out_dir / f"{self.tag}.err"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        self.t0 = time.perf_counter()
        with open(self.out, "w") as fo, open(self.err, "w") as fe:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", f"repro_torch.examples.{name}", *self.argv],
                stdout=fo, stderr=fe, env=env, cwd=str(ROOT))
        self.t1 = None  # set by the waiter when the child exits
        self._waiter = threading.Thread(target=self._wait, daemon=True)
        self._waiter.start()

    def _wait(self) -> None:
        self.proc.wait()
        self.t1 = time.perf_counter()

    def finish(self, timeout: float = 600) -> tuple[str, float]:
        """Wait; the exit code must be 0 and the last line ``OK``.  Returns
        the standard output and the child's wall seconds."""
        self._waiter.join(timeout=max(0.0, self.t0 + timeout - time.perf_counter()))
        self.kill()
        code = self.proc.returncode
        wall = (self.t1 or time.perf_counter()) - self.t0
        text = self.out.read_text()
        if code != 0 or text.rstrip().splitlines()[-1:] != ["OK"]:
            raise AssertionError(f"example {self.name} {' '.join(self.argv)}: exit {code}, last "
                                 f"lines:\n{text[-2000:]}\n{self.err.read_text()[-4000:]}")
        return text, wall

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _stencil_launches(name: str, text: str) -> tuple[int, int]:
    """An example's ``stencil_tiles launches: L (T tiles in W waves)`` line:
    L and W, which must be equal."""
    m = re.search(r"^stencil_tiles launches: (\d+) \((\d+) tiles in (\d+) waves\)$", text, re.M)
    if m is None:
        raise AssertionError(f"example {name} printed no launch line:\n{text[-2000:]}")
    launches, waves = int(m.group(1)), int(m.group(3))
    if launches != waves or waves == 0:
        raise AssertionError(f"example {name}: {launches} stencil_tiles launches for {waves} "
                             f"waves")
    return launches, waves


def _train_lm_log(text: str) -> dict:
    """``train_lm``'s output: its logged losses by step, and the first and
    last step of its summary line."""
    losses = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"^step\s+(\d+)\s+loss (\S+)\s+lr \S+\s+\S+s$", text, re.M)}
    m = re.search(r"^steps (\d+)-(\d+) on ", text, re.M)
    if m is None or not losses:
        raise AssertionError(f"train_lm printed no losses or no summary:\n{text[-2000:]}")
    return {"losses": losses, "start": int(m.group(1)) - 1, "end": int(m.group(2))}


def _ckpt_leaves(ckpt_dir: Path, step: int) -> dict:
    with np.load(ckpt_dir / f"step_{step:010d}" / "leaves.npz") as z:
        return {k: z[k] for k in z.files}


def _preempt_after_first_checkpoint(child: _Example, ckpt: Path, timeout: float = 600) -> None:
    """Raise ``train_lm``'s ``PREEMPT`` sentinel as soon as its
    step-``EXAMPLES_CKPT_EVERY`` checkpoint is committed (the trainer then
    checkpoints the step it is in and exits)."""
    committed = ckpt / f"step_{EXAMPLES_CKPT_EVERY:010d}" / "manifest.json"
    while child.proc.poll() is None and not committed.exists():
        if time.perf_counter() - child.t0 > timeout:
            raise AssertionError(f"train_lm wrote no step-{EXAMPLES_CKPT_EVERY} checkpoint in "
                                 f"{timeout} s")
        time.sleep(0.02)
    (ckpt / "PREEMPT").touch()


def phase_examples(device, smi: str) -> dict:
    """Slice 13's examples as a user runs them: ``python -m
    repro_torch.examples.<name>`` as a child with no ``--device`` (so on the
    card), exit 0 and ``OK`` last.  ``quickstart``, ``stencil_pipeline``,
    ``serve_decode`` and ``pipeline_parallel`` run side by side, beside
    ``train_lm --steps EXAMPLES_TRAIN_STEPS`` (``CFG_100M``, batch 4 x 256)
    stopped by its ``PREEMPT`` sentinel after its step-50 checkpoint and
    then rerun with the same command.  ``quickstart`` and
    ``stencil_pipeline`` launch ``stencil_tiles`` once per wave;
    ``serve_decode`` (the launcher at ``--smoke``) ``decode_attention`` once
    per attention layer per decode step; ``pipeline_parallel`` runs 4 gloo
    ranks on the card.  Then, alone, the uninterrupted run through
    ``train_lm.run`` in this process (its step time, tokens/s and peak
    memory): the logged losses it shares with the preempted and resumed runs
    and their last common checkpoint (every parameter and moment) must be
    bit-equal.  Then one profiled ``CFG_100M`` step (device busy share) and
    the card-vs-CPU gradients of its 2-layer cut (dense attention's backward
    on CUDA)."""
    import contextlib as _ctx
    import io
    import tempfile

    from repro_torch.configs import get_smoke_config
    from repro_torch.examples import train_lm
    from repro_torch.models.lm import param_leaves
    from repro_torch.train.loop import Trainer
    from repro_torch.train.steps import TrainHParams

    cfg100 = train_lm.CFG_100M
    steps = EXAMPLES_TRAIN_STEPS
    root = Path(tempfile.mkdtemp(prefix="examples_", dir=ROOT / "build"))
    straight_dir, resumed_dir = root / "straight", root / "resumed"
    train_argv = ["--steps", str(steps), "--ckpt-dir", str(resumed_dir)]
    side = [_Example(name, out_dir=root) for name in
            ("quickstart", "stencil_pipeline", "serve_decode", "pipeline_parallel")]
    preempted = _Example("train_lm", train_argv, out_dir=root, tag="train_lm_preempted")
    children = [*side, preempted]
    try:
        _preempt_after_first_checkpoint(preempted, resumed_dir)
        first_text, wall_first = preempted.finish()
        (resumed_dir / "PREEMPT").unlink()
        rerun = _Example("train_lm", train_argv, out_dir=root, tag="train_lm_rerun")
        children.append(rerun)
        second_text, wall_second = rerun.finish()
        done = {child.name: child.finish() for child in side}
    finally:
        for child in children:
            child.kill()
    walls = {name: wall for name, (_, wall) in done.items()}
    launches = {}
    for name in ("quickstart", "stencil_pipeline"):
        text = done[name][0]
        launches[name], waves = _stencil_launches(name, text)
        log(f"[examples] python -m repro_torch.examples.{name}: exit 0, OK, {walls[name]:.1f} s; "
            f"stencil_tiles launches {launches[name]} = waves {waves}; "
            + "; ".join(line.strip() for line in text.splitlines()
                        if "bit-exact" in line or "oracle" in line or "(AXI)" in line))
    text = done["serve_decode"][0]
    m = re.search(r"^kernel launches: decode_attention (\d+), ssd_scan (\d+) \((\d+) decode "
                  r"steps\)$", text, re.M)
    n_attn = _self_attention_layers(get_smoke_config("qwen3-0.6b"))
    if m is None or int(m.group(1)) != n_attn * int(m.group(3)) or int(m.group(2)) != 0:
        raise AssertionError(f"serve_decode's launches: {m and m.group(0)}, want "
                             f"decode_attention = {n_attn} layers x decode steps")
    launches["serve_decode"] = int(m.group(1))
    log(f"[examples] python -m repro_torch.examples.serve_decode: exit 0, OK, "
        f"{walls['serve_decode']:.1f} s; {m.group(0)} (= {n_attn} attention layers of the "
        f"qwen3-0.6b SMOKE config x {m.group(3)}); "
        + "; ".join(line.strip() for line in text.splitlines()
                    if line.startswith(("qwen3", "decode:"))))
    text = done["pipeline_parallel"][0]
    m = re.search(r"err=(\S+), bubble fraction \(S-1\)/\(M\+S-1\) = 3/11", text)
    if m is None or not float(m.group(1)) < 1e-5:
        raise AssertionError(f"pipeline_parallel: {text[-2000:]}")
    log(f"[examples] python -m repro_torch.examples.pipeline_parallel (4 gloo ranks on the "
        f"card, staged through the host): exit 0, OK, {walls['pipeline_parallel']:.1f} s; "
        f"err {m.group(1)} (< 1e-5), bubble 3/11; the four side examples' walls are taken "
        f"side by side with each other and with train_lm's two runs")
    first, second = _train_lm_log(first_text), _train_lm_log(second_text)
    log(f"[examples] python -m repro_torch.examples.train_lm {' '.join(train_argv)}: stopped "
        f"by the PREEMPT sentinel after its step-{EXAMPLES_CKPT_EVERY} checkpoint, steps "
        f"1-{first['end']} ({wall_first:.1f} s); the same command again resumed at step "
        f"{second['start']} and ran steps {second['start'] + 1}-{second['end']} "
        f"({wall_second:.1f} s)")
    # the uninterrupted run, alone on the card: train_lm.run in this process
    _free()
    out = io.StringIO()
    t0 = time.perf_counter()
    with _ctx.redirect_stdout(out):
        straight = train_lm.run(cfg100, steps=steps, batch=4, seq=256,
                                ckpt_dir=str(straight_dir), device=device)
    wall_straight = time.perf_counter() - t0
    want = {m_["step"]: m_["loss"] for m_ in straight["log"]}
    got = {**first["losses"], **second["losses"]}
    shared = sorted(set(want) & set(got))
    bit = bool(shared) and all(got[k] == want[k] for k in shared)
    rel = max((abs(got[k] - want[k]) / abs(want[k]) for k in shared), default=float("nan"))
    common = [k for k in range(EXAMPLES_CKPT_EVERY, steps + 1, EXAMPLES_CKPT_EVERY)
              if k > first["end"]]
    if not common:
        raise AssertionError(f"the preempted run stopped at step {first['end']}: no checkpoint "
                             f"of the uninterrupted {steps} steps comes after it")
    a, b = _ckpt_leaves(straight_dir, common[-1]), _ckpt_leaves(resumed_dir, common[-1])
    same_ckpt = a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    del a, b
    dts = [m_["dt"] for m_ in straight["log"][1:]]
    step_s = straight["wall_s"] / steps
    tokens = 4 * 256
    log(f"[examples] train_lm.run (the uninterrupted run, in this process, alone on the card; "
        f"CFG_100M: {cfg100.n_layers} layers, d_model {cfg100.d_model}, {cfg100.n_heads} heads, "
        f"{cfg100.n_kv_heads} KV heads, d_ff {cfg100.d_ff}, vocab {cfg100.vocab}; batch 4 x "
        f"256, AdamW, remat, bf16 compute): steps 1-{straight['end']} in "
        f"{straight['wall_s']:.3f} s ({wall_straight:.1f} s with the model's set-up), "
        f"{step_s * 1e3:.3f} ms/step and {tokens / step_s:.1f} tokens/s with the checkpoints "
        f"every {EXAMPLES_CKPT_EVERY}; median logged step {statistics.median(dts) * 1e3:.3f} ms "
        f"({tokens / statistics.median(dts):.1f} tokens/s); peak max_memory_allocated "
        f"{straight['peak_bytes'] / 2 ** 30:.3f} GiB; card: {smi}")
    log(f"[examples] resumed against uninterrupted: {len(shared)} logged losses shared "
        f"(steps {shared[0] if shared else '-'}-{shared[-1] if shared else '-'}): bit-equal "
        f"{bit}, max relative difference {rel:.3e}; the step-{common[-1]} checkpoints (every "
        f"parameter and moment) bit-equal {same_ckpt}")
    if not (first["start"] == 0 and first["end"] >= EXAMPLES_CKPT_EVERY
            and second["start"] == first["end"] and second["end"] == first["end"] + steps
            and bit and same_ckpt and all(math.isfinite(v) for v in got.values())):
        raise AssertionError("train_lm's resumed run differs from the uninterrupted run")
    # one profiled step of CFG_100M in this process (no checkpoints), after warm-up
    _free()
    hp = TrainHParams(peak_lr=3e-4, warmup=20, total_steps=steps, remat=True)
    trainer = Trainer(cfg100, batch=4, seq=256, ckpt_dir=root / "profile", hp=hp,
                      ckpt_every=10 ** 9, device=device)
    trainer.run(3, log_every=1)
    batch_t = {"tokens": torch.as_tensor(trainer.data.batch_at(3)["tokens"], device=device)}
    prof = _profile_step(trainer, batch_t, tag="[examples]")
    trainer.data.close()
    n_params = sum(p.numel() for leaf in param_leaves(trainer.model) for p in leaf.parts
                   if leaf.path[0] != "embed")
    del trainer
    flops = 8 * n_params * tokens
    med = statistics.median(dts)
    log(f"[examples] CFG_100M model FLOPs 8 N tokens with remat, N = {n_params} non-embedding "
        f"parameters: {flops / 1e12:.4f} TFLOP per step, {flops / med / PEAK_BF16_TC_FLOPS:.3%} "
        f"of 989 TFLOP/s at the median step")
    _free()
    check = _grads_cpu_check(device, dataclasses.replace(
        cfg100, n_layers=EXAMPLES_CPU_LAYERS, compute_dtype="float32"), EXAMPLES_CPU_SEQ,
        "[examples]")
    _free()
    return {"walls": walls, "launches": launches, "step_ms": step_s * 1e3,
            "median_step_ms": med * 1e3, "peak_gib": straight["peak_bytes"] / 2 ** 30,
            "first_end": first["end"], "bit": bit, "common": common[-1],
            "busy": None if prof is None else prof["busy_s"] / prof["wall_s"], "flops": flops,
            **check}


def phase_dryrun_start() -> list:
    """Start ``[dryrun]``'s cells, one ``python -m repro_torch.launch.dryrun``
    process each (host only: a fake world of 256 / 512 ranks on meta
    tensors; no CUDA device is visible to them), to run beside the
    pipeline and tools phases."""
    import tempfile

    root = Path(tempfile.mkdtemp(prefix="dryrun_", dir=ROOT / "build"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch, cell, mesh in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--cell", cell,
               "--mesh", mesh, "--out", str(root)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                env=env)
        procs.append((proc, (arch, cell, mesh), root, time.perf_counter()))
    return procs


def phase_dryrun_finish(procs: list) -> dict:
    """Wait for ``[dryrun]``'s cells: each must exit 0 with an ``ok``
    record; prints its FLOPs (FlopCounterMode), per-rank argument bytes and
    collectives by kind."""
    recs = {}
    for proc, (arch, cell, mesh), root, t0 in procs:
        out, err = proc.communicate(timeout=900)
        wall = time.perf_counter() - t0
        path = root / f"{arch}__{cell}__{mesh}.json"
        rec = json.loads(path.read_text()) if path.exists() else {"status": "missing"}
        if proc.returncode != 0 or rec["status"] != "ok":
            raise AssertionError(f"dryrun {arch} {cell} {mesh}: exit {proc.returncode}, "
                                 f"{rec.get('status')}\n{out[-2000:]}\n{err[-4000:]}\n"
                                 f"{rec.get('trace', '')}")
        mem = rec["memory"]
        log(f"[dryrun] python -m repro_torch.launch.dryrun --arch {arch} --cell {cell} --mesh "
            f"{mesh}: {rec['status']} (build {rec['t_build_s']} s, step {rec['t_step_s']} s on "
            f"{rec['n_devices']} fake ranks; collected {wall:.1f} s after its start); flops {rec['flops']:.4g} ({rec['flops_source']}); "
            f"per-rank arguments {mem['argument_size_in_bytes']} B {mem['arguments']}, outputs "
            f"{mem['output_size_in_bytes']} B; collectives {rec['collectives']['counts']}, "
            f"bytes {rec['collectives']['bytes']}; no counterpart: {rec['no_counterpart']}")
        recs[(arch, cell, mesh)] = rec
    return recs


def _ssd_bwd_bound(B: int, T: int, H: int, P: int, N: int, L: int,
                   esize: int) -> tuple[float, str, float]:
    """(bound ms, what bounds it, the f32-pipe operations figure) of one
    backward call: x, dy, the saved states, loga, B and C read once; dx,
    dloga, dB and dC written once; against its products — per chunk 2 L^2 N
    (G) + 4 L^2 N (dG B, dG^T C), per head and chunk 4 L^2 P (dy x^T, W^T dy)
    + 8 L P N (dS, the facet term, dy^T S, x^T dS) — at the peak for the
    inputs' type (the bf16 tensor cores for bf16), and always at the f32 peak
    for the third value (the FP32-pipe figure)."""
    nc = T // L
    nbytes = (3 * B * T * H * P + 4 * B * T * N) * esize + B * nc * H * P * N * 4 \
        + 2 * B * T * H * 4
    flops = B * nc * (6 * L * L * N + H * (4 * L * L * P + 8 * L * P * N))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_f32 = flops / PEAK_FLOPS[torch.float32] * 1e3
    t_ops = flops / PEAK_BF16_TC_FLOPS * 1e3 if esize == 2 else t_f32
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")) + (t_f32,)


def _kernel_name(key: str) -> str:
    """A profiler row's kernel name without its namespace and arguments."""
    return key.replace("(anonymous namespace)::", "").removeprefix("void ").split("(", 1)[0]


#: the kernels of csrc/ssd_scan_bwd.cu (both routes)
SSD_BWD_KERNELS = ("local_mma", "local_fma", "pass_kernel", "head_mma", "head_fma", "cross_mma",
                   "cross_fma")


def _launch_ms(fn) -> dict:
    """Device ms of each kernel one call of ``fn`` launches, by kernel name,
    from one CUDA-only profiler window after a warm-up call; empty when the
    profiler reports no kernel rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            name = _kernel_name(e.key)
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3
    return out


def _ssd_bwd_launch_rows(shapes) -> list[dict]:
    """Each ``ssd_scan_bwd`` launch's device ms at each (B, T, H, P, N,
    chunk) in bfloat16, from one profiled call on seeded inputs."""
    from repro_torch.kernels.ssd import ssd as ssd_mod
    from repro_torch.kernels.ssd import ssd_scan_bwd

    device = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    rows = []
    for B, T, H, P, N, L in shapes:
        x = rng_tensor(rng, (B, T, H, P), torch.bfloat16, device)
        loga = -rng_tensor(rng, (B, T, H), torch.float32, device).abs() * 0.5
        Bm = (rng_tensor(rng, (B, T, N), torch.float32, device) / math.sqrt(N)).bfloat16()
        C = (rng_tensor(rng, (B, T, N), torch.float32, device) / math.sqrt(N)).bfloat16()
        dy = rng_tensor(rng, (B, T, H, P), torch.bfloat16, device)
        _, _, states = ssd_mod._forward(x, loga, Bm, C, L, save_states=True)
        rows.append(_launch_ms(lambda: ssd_scan_bwd(x, loga, Bm, C, dy, chunk=L, states=states)))
        del x, loga, Bm, C, dy, states
        torch.cuda.empty_cache()
    return rows


#: the per-launch profile runs in a fresh process: late in this script's
#: process the profiler reports no kernel rows (a CUDA-only window after the
#: serve and train phases' windows and graph captures)
_LAUNCH_CHILD = """
import json, sys
sys.path.insert(0, {root!r})
import chip_smoke
print("LAUNCH_MS " + json.dumps(chip_smoke._ssd_bwd_launch_rows({shapes!r})))
"""


def _ssd_bwd_launch_ms(shapes) -> list[dict]:
    """:func:`_ssd_bwd_launch_rows` in a child process (waited for); empty
    rows, and a logged reason, if the child fails."""
    res = subprocess.run([sys.executable, "-c", _LAUNCH_CHILD.format(root=str(ROOT),
                                                                     shapes=list(shapes))],
                         capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    for line in res.stdout.splitlines():
        if line.startswith("LAUNCH_MS "):
            return json.loads(line[len("LAUNCH_MS "):])
    log(f"[timing] ssd_scan_bwd per launch: the child process failed (rc {res.returncode}): "
        f"{res.stderr[-800:]}")
    return [{} for _ in shapes]


def phase_train_timing(device) -> dict:
    """``ssd_scan_bwd`` at the training and serve shapes (bf16) by graph
    replay, beside its plain version, the forward at the same shape, its
    bound and its FP32-pipe figure."""
    from repro_torch.kernels.ssd import ssd as ssd_mod
    from repro_torch.kernels.ssd import ssd_chunked_bwd_ref, ssd_scan, ssd_scan_bwd

    shapes = (SSD_TRAIN_SHAPE, (1, SERVE_PROMPTS[1], 32, 64, 128, 128))
    launch_rows = _ssd_bwd_launch_ms(shapes)
    rng = np.random.default_rng(SEED)
    row = None
    for (B, T, H, P, N, L), per_launch in zip(shapes, launch_rows):
        x = rng_tensor(rng, (B, T, H, P), torch.bfloat16, device)
        loga = -rng_tensor(rng, (B, T, H), torch.float32, device).abs() * 0.5
        Bm = (rng_tensor(rng, (B, T, N), torch.float32, device) / math.sqrt(N)).bfloat16()
        C = (rng_tensor(rng, (B, T, N), torch.float32, device) / math.sqrt(N)).bfloat16()
        dy = rng_tensor(rng, (B, T, H, P), torch.bfloat16, device)
        _, _, states = ssd_mod._forward(x, loga, Bm, C, L, save_states=True)
        got = ssd_scan_bwd(x, loga, Bm, C, dy, chunk=L, states=states)
        want = ssd_chunked_bwd_ref(x, loga, Bm, C, dy, None, L)
        err = max(max_abs(a, b) for a, b in zip(got, want))
        ex = max(_bwd_excess(got, want, torch.bfloat16))
        del want
        iters = 4 if B > 1 else 20
        m = _measure(lambda: ssd_scan_bwd(x, loga, Bm, C, dy, chunk=L, states=states), iters)
        fwd = _measure(lambda: ssd_scan(x, loga, Bm, C, chunk=L), iters)
        plain_ms = _time_ms(lambda: ssd_chunked_bwd_ref(x, loga, Bm, C, dy, None, L), 2,
                            warmup=1, repeats=3)[0]
        bound_ms, bound_by, f32_ms = _ssd_bwd_bound(B, T, H, P, N, L, 2)
        plan = ssd_mod.backward_plan(B, T, H, P, N, L)
        shape = "the training shape" if B > 1 else "the serve shape"
        log(f"[timing] ssd_scan_bwd B={B} T={T} H={H} P={P} N={N} chunk={L} bfloat16 "
            f"({shape}): kernel {_fmt(m)}; "
            f"plain (autograd through ssd_chunked_ref) {plain_ms:.6f} ms (eager CUDA events); "
            f"the forward ssd_scan at this shape {_fmt(fwd)}; bound {bound_ms:.6f} ms "
            f"({bound_by}), {bound_ms / m['ms']:.1%} of bound; the FP32-pipe operations bound "
            f"{f32_ms:.6f} ms; launches {plan.grids} = {plan.ctas} CTAs of 256 threads, "
            f"shared memory {plan.smem} B, scratch {plan.scratch} B, saved states {plan.saved} "
            f"B; max|kernel-plain| {err!r} ({ex:.3f} x the limit)")
        log(f"[timing] ssd_scan_bwd ({shape}) per launch, device ms of one profiled call in a "
            f"fresh process: " + (
            ", ".join(f"{k} {v:.6f}" for k, v in per_launch.items()) or
            "not measured (the profiler reported no kernel rows)"))
        if not ex <= 1.0:
            raise AssertionError(f"ssd_scan_bwd differs from plain at the path shape: {err!r}")
        if row is None:
            row = {"ms": m["ms"], "host_ms": m["host_ms"], "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "err": err}
        del states, got
        _free()
    return row


def _attn_bound(lengths: torch.Tensor, Hq: int, Hkv: int, D: int, esize: int,
                q_esize: int) -> tuple[float, str]:
    """The valid K/V prefix read once plus q and out, against 4 D flops per
    query head and valid key (q.k and p.v) at the f32 peak."""
    n_keys = int(lengths.sum())
    B = lengths.numel()
    nbytes = 2 * n_keys * Hkv * D * esize + 2 * B * Hq * D * q_esize + 4 * B
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 4 * D * Hq * n_keys / PEAK_FLOPS[torch.float32] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _ssd_bound(B: int, T: int, H: int, P: int, N: int, L: int,
               esize: int) -> tuple[float, str, float]:
    """(bound ms, what bounds it, the f32-pipe operations figure): x, loga,
    B, C, y and the state moved once, against 2 L^2 N flops per chunk plus
    2 L^2 P + 4 L P N per head and chunk — at the bf16 tensor-core peak for
    a bf16 call (the kernel's route), at the f32 peak for an f32 call; the
    third value is always the flops at the f32 peak (the FP32-pipe route's
    bound)."""
    nbytes = (2 * B * T * H * P + 2 * B * T * N) * esize + B * T * H * 4 + B * H * P * N * 4
    flops = B * (T // L) * (2 * L * L * N + H * (2 * L * L * P + 4 * L * P * N))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_f32 = flops / PEAK_FLOPS[torch.float32] * 1e3
    t_ops = flops / PEAK_BF16_TC_FLOPS * 1e3 if esize == 2 else t_f32
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")) + (t_f32,)


def phase_serve_timing(device, runs: dict) -> dict:
    """Both kernels at their serve-path shapes, beside their plain versions,
    their bounds and (decode attention) SDPA as a yardstick."""
    import torch.nn.functional as F

    from repro_torch.kernels.block_attention import (blockify, deblockify, decode_attention,
                                                     decode_attention_ref)
    from repro_torch.kernels.block_attention.block_attention import launch_plan
    from repro_torch.kernels.ssd import ssd_chunked_ref, ssd_scan
    from repro_torch.kernels.ssd.ssd import P_BLOCK as SSD_P_BLOCK
    from repro_torch.kernels.ssd.ssd import launch_plan as ssd_plan

    rng = np.random.default_rng(SEED)
    rows = {}
    cfg = _serve_cfg("qwen3-0.6b")
    B, Hq, Hkv, D, bs = SERVE_LANES, cfg.padded_q_heads, cfg.stored_kv_heads, cfg.head_dim, cfg.kv_block
    nb = -(-SERVE_MAX_SEQ // bs)
    lengths = torch.as_tensor(runs["qwen3-0.6b"]["decode_lengths"], dtype=torch.int32,
                              device=device)
    q = rng_tensor(rng, (B, Hq, D), torch.bfloat16, device)
    kb = rng_tensor(rng, (B, nb, Hkv, bs, D), torch.bfloat16, device)
    vb = rng_tensor(rng, (B, nb, Hkv, bs, D), torch.bfloat16, device)
    # the yardstick: SDPA over the deblockified cache, same mask, laid out outside the window
    kd, vd = (deblockify(t).permute(0, 2, 1, 3).contiguous() for t in (kb, vb))
    mask = (torch.arange(nb * bs, device=device)[None, :] < lengths[:, None].long())[:, None, None]
    q4 = q[:, :, None]

    def sdpa():
        return F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask, enable_gqa=True)

    got = decode_attention(q, kb, vb, lengths)
    want = decode_attention_ref(q, deblockify(kb), deblockify(vb), lengths)
    err, ex = max_abs(got, want), _excess(got, want, ATTN_TOL[torch.bfloat16])
    err_lib = max_abs(got, sdpa()[:, :, 0])
    m = _measure(lambda: decode_attention(q, kb, vb, lengths), 200)
    plain_ms = _time_ms(
        lambda: decode_attention_ref(q, deblockify(kb), deblockify(vb), lengths), 20, warmup=3)[0]
    lib = _measure(sdpa, 200)
    bound_ms, bound_by = _attn_bound(lengths, Hq, Hkv, D, 2, 2)
    plan = launch_plan(B, Hq, Hkv, nb, bs, D, 2)
    log(f"[timing] decode_attention qwen3-0.6b decode tick: B={B} Hq={Hq} Hkv={Hkv} D={D} "
        f"bs={bs} nb={nb} bfloat16, lengths {lengths.tolist()} (a mid-run tick of the serve "
        f"path): kernel {_fmt(m)}; plain {plain_ms:.6f} ms (eager CUDA events); "
        f"scaled_dot_product_attention over the deblockified cache {_fmt(lib)}; bound "
        f"{bound_ms:.6f} ms ({bound_by}), {bound_ms / m['ms']:.1%} of bound; max|kernel-plain| "
        f"{err!r} ({ex:.3f} x the limit), max|kernel-sdpa| {err_lib!r}")
    log(f"[timing] decode_attention launch at this tick: grid {plan.grid} = "
        f"{math.prod(plan.grid)} CTAs, {plan.working(lengths.tolist())} working (split "
        f"{plan.split} positions, {plan.nspb} per block), {plan.sub}-row sub-tiles in a "
        f"{plan.smem} B shared-memory ring per CTA ({'bulk copies' if plan.bulk else 'word loads'})"
        f"; {233472 // (plan.smem + 1024)} CTAs fit an SM's shared memory")
    if not ex <= 1.0:
        raise AssertionError(f"decode_attention differs from plain at the path shape: {err!r}")
    rows["decode_attention"] = {"ms": m["ms"], "host_ms": m["host_ms"], "plain_ms": plain_ms,
                                "bound_ms": bound_ms, "bound_by": bound_by,
                                "library_ms": lib["ms"], "err": err}

    cfg = _serve_cfg("mamba2-370m")
    H, P, N, L = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    for Bb in (1, 4):
        T = SERVE_PROMPTS[1]
        x = rng_tensor(rng, (Bb, T, H, P), torch.bfloat16, device)
        loga = -rng_tensor(rng, (Bb, T, H), torch.float32, device).abs() * 0.5
        Bm = (rng_tensor(rng, (Bb, T, N), torch.float32, device) / math.sqrt(N)).bfloat16()
        C = (rng_tensor(rng, (Bb, T, N), torch.float32, device) / math.sqrt(N)).bfloat16()
        y, st = ssd_scan(x, loga, Bm, C, chunk=L)
        wy, wst = ssd_chunked_ref(x, loga, Bm, C, L)
        err = max(max_abs(y, wy), max_abs(st, wst))
        ex = max(_excess(y, wy, SSD_TOL[torch.bfloat16]), _excess(st, wst, STATE_TOL))
        plan = ssd_plan(Bb, T, H, P, N, L, torch.bfloat16)
        log(f"[timing] ssd_scan launch plan at B={Bb} T={T}: grid {plan.grid} = {plan.ctas} CTAs "
            f"of {plan.threads} threads ({SSD_P_BLOCK} state rows each), route {plan.route}, chunk "
            f"padded to {plan.lp}, state to {plan.np_}, {plan.stages} staging stage(s), "
            f"{plan.smem} B of shared memory per CTA, {plan.ctas_per_sm} CTA(s) per SM")
        m = _measure(lambda: ssd_scan(x, loga, Bm, C, chunk=L), 20)
        plain_ms = _time_ms(lambda: ssd_chunked_ref(x, loga, Bm, C, L), 5, warmup=2)[0]
        bound_ms, bound_by, f32_ms = _ssd_bound(Bb, T, H, P, N, L, 2)
        log(f"[timing] ssd_scan mamba2-370m prefill: B={Bb} T={T} H={H} P={P} N={N} chunk={L} "
            f"bfloat16: kernel {_fmt(m)}; plain {plain_ms:.6f} ms (eager CUDA events); bound "
            f"{bound_ms:.6f} ms ({bound_by}; tensor-core route), {bound_ms / m['ms']:.1%} of "
            f"bound; the FP32-pipe operations bound {f32_ms:.6f} ms; max|kernel-plain| {err!r} "
            f"({ex:.3f} x the limit)")
        if not ex <= 1.0:
            raise AssertionError(f"ssd_scan differs from plain at the path shape: {err!r}")
        if Bb == 1:  # one call captured in a CUDA graph equals the eager call
            graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                ssd_scan(x, loga, Bm, C, chunk=L)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            with torch.cuda.graph(graph):
                gy, gst = ssd_scan(x, loga, Bm, C, chunk=L)
            graph.replay()
            torch.cuda.synchronize()
            same = bit_equal(gy, y) and bit_equal(gst, st)
            log(f"[timing] ssd_scan B=1: one call captured in a CUDA graph and replayed == the "
                f"eager call bit for bit: {same}")
            if not same:
                raise AssertionError("ssd_scan under graph replay differs from the eager call")
            del graph
        if Bb == 1:
            rows["ssd_scan"] = {"ms": m["ms"], "host_ms": m["host_ms"], "plain_ms": plain_ms,
                                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                                "err": err}
    return rows


def log_clocks() -> None:
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,power.draw,power.limit,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"[timing] after timing: name, sm clock, max sm clock, power, power limit, "
        f"temperature: {clocks}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=None,
                    help="time steps of the full-width paths (default: each path's "
                         f"size, {MAIN_SPACE[0]}, {IRREDUNDANT_SPACE[0]}, "
                         f"{COMPRESSED_SPACE[0]} and {H100_SPACE[0]})")
    ap.add_argument("--pipeline-rank", default=None, metavar="DIR",
                    help="run one rank of the [pipeline] phase's child (under "
                         "torch.distributed.run), writing into DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if args.pipeline_rank is not None:
        return _pipe_rank(args.pipeline_rank)
    # keep the autotuner's decision cache inside the checkout
    os.environ.setdefault("REPRO_AUTOTUNE_CACHE", str(ROOT / "build" / "autotune"))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    # float32 products in full float32 (the plain versions are the yardstick)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def cut(space):
        return space if args.steps is None else (min(args.steps, space[0]), *space[1:])

    smi = phase_device()
    phase_build()
    worst = phase_kernels(device)
    worst_fetch = phase_fetch(device)
    phase_small(device)
    phase_storage(device)
    # every CPU+CUDA profiler window (dataflow, the attention wrapper, serve)
    # runs before the timing phases' CUDA-only windows and graph captures:
    # after those, such a window reported no kernel rows on the card
    worst_attn = phase_attn_kernel(device)
    worst_ssd = phase_ssd_kernel(device)
    worst_ssd_bwd = phase_ssd_bwd_kernel(device)
    main_run = phase_main(device, cut(MAIN_SPACE))
    worst_sharded = phase_kernels_sharded(device, main_run)
    sharded_run = phase_sharded(device, main_run)
    dataflow_run = phase_dataflow(device, main_run)
    del main_run["facets"]
    irr_run = phase_irredundant(device, cut(IRREDUNDANT_SPACE))
    fetch_sharded_run = phase_fetch_sharded(device, irr_run)
    phase_compressed(device, cut(COMPRESSED_SPACE))
    phase_distribute(device)
    phase_halo_quantize(device)
    phase_calibrate(device, smi)
    h100_run = phase_h100_target(device, cut(H100_SPACE))
    runs = {}
    for arch in SERVE_ARCHS:
        runs[arch] = phase_serve(device, arch)
        _free()  # the model (olmoe: 13.8 GB) goes before the next
    ctx_runs = {arch: phase_serve_ctx(device, arch) for arch in CTX_ARCHS}
    jamba_run = phase_jamba_smoke(device)
    _free()
    train_run = phase_train(device)
    mesh_run = phase_train_mesh(device, train_run["batch"], smi)
    dry = phase_dryrun_start()
    try:
        phase_pipeline(device, smi)
        tools_run = phase_tools(device)
        phase_dryrun_finish(dry)
    finally:
        for proc, *_ in dry:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    # after the dry run's children: train_lm's host-bound steps get the host's cores
    examples_run = phase_examples(device, smi)
    rows = phase_timing(device, main_run, irr_run)
    fetch_row = phase_fetch_timing(irr_run)
    sharded_rows = phase_sharded_timing(device, main_run, irr_run, fetch_row,
                                        fetch_sharded_run["assignment"])
    serve_rows = phase_serve_timing(device, runs)
    bwd_row = phase_train_timing(device)
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
        "host_ms": row["host_ms"],
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
    for name, source, replaces, arch, worst_k in (
            ("decode_attention", "src/repro_torch/kernels/block_attention/csrc/block_attention.cu",
             "src/repro/kernels/block_attention/block_attention.py:78", "qwen3-0.6b", worst_attn),
            ("ssd_scan", "src/repro_torch/kernels/ssd/csrc/ssd_scan.cu",
             "src/repro/kernels/ssd/ssd.py:87", "mamba2-370m", worst_ssd)):
        row = serve_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": runs[arch]["launches"][name],
            "max_abs_err": max(worst_k, row["err"]),
            **{k: row[k] for k in ("ms", "host_ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")},
        })
    # the SSD's gradient: no Pallas counterpart (the JAX package differentiates its jnp SSD)
    kernels.append({
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/models/mamba2.py:106",
        "launches": train_run["launches"]["ssd_scan_bwd"],
        "max_abs_err": max(worst_ssd_bwd, bwd_row["err"]),
        **{k: bwd_row[k] for k in ("ms", "host_ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")},
    })
    # the per-port wrappers launch the kernels of rows 1 and 2 (no source of their own)
    for name, source, replaces, launches, worst_k in (
            ("execute_tiles_sharded", "src/repro_torch/kernels/stencil/csrc/stencil_tiles.cu",
             "src/repro/kernels/stencil/ops.py:35", sharded_run["launches"],
             max(worst_sharded, sharded_rows["execute_tiles_sharded"]["err"])),
            ("fetch_interior_halos_sharded",
             "src/repro_torch/kernels/facet_fetch/csrc/facet_fetch.cu",
             "src/repro/kernels/facet_fetch/ops.py:11", fetch_sharded_run["launches"],
             fetch_sharded_run["err"])):
        row = sharded_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": worst_k,
            **{k: row[k] for k in ("ms", "host_ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")},
        })
    log(f"[done] launches per path: stencil_tiles [main] {main_run['launches']}, [sharded] "
        f"{sharded_run['launches']} ({sharded_run['waves']} waves x {sharded_run['n_ports']} "
        f"ports), [dataflow] {dataflow_run['launches']}, [irredundant] "
        f"{irr_run['launches']['stencil_tiles']}, [h100-target] {h100_run['launches']}; "
        f"facet_fetch [irredundant] "
        f"{irr_run['launches']['facet_fetch']}, [fetch-sharded] {fetch_sharded_run['launches']}")
    paths = {**runs, **ctx_runs, f"{JAMBA} SMOKE": jamba_run}
    log("[done] launches per serve path: " + "; ".join(
        f"{name} decode_attention {r['launches']['decode_attention']}, ssd_scan "
        f"{r['launches']['ssd_scan']}" for name, r in paths.items()))
    launches = train_run["launches"]
    log(f"[done] launches over the training path ({TRAIN_ARCH}, batch {train_run['batch']}, "
        f"{2 * TRAIN_STEPS} steps through the launcher): ssd_scan {launches['ssd_scan']}, "
        f"ssd_scan_bwd {launches['ssd_scan_bwd']}; over the meshed path ({TRAIN_MESH_STEPS} "
        f"steps): ssd_scan {mesh_run['launches']['ssd_scan']}, ssd_scan_bwd "
        f"{mesh_run['launches']['ssd_scan_bwd']}")
    log(f"[done] launches over [tools]: stencil_tiles {tools_run['traced']['cuda']['launches']} "
        f"(cfa_trace --backend cuda, one per wave), 0 (--backend dataflow: the plain version), "
        f"{len(KERNEL_CASES)} (stencil_tile_op); [pipeline] and [dryrun] launch no kernel of "
        f"the port (dense blocks; meta tensors)")
    w = examples_run["launches"]
    log(f"[done] launches over [examples] (each in its own process): stencil_tiles "
        f"{w['quickstart']} (quickstart) and {w['stencil_pipeline']} "
        f"(stencil_pipeline), one per wave; decode_attention {w['serve_decode']} "
        f"(serve_decode); train_lm and pipeline_parallel launch no kernel of the port (dense "
        f"attention's eager forward and backward; tanh(h @ w))")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
