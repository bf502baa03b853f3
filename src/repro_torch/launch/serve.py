"""Serving launcher: batched prefill + decode over the facet-layout KV cache
(the port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke \\
        --device cpu --batch 4 --prompt-len 32 --gen 32

Runs on the CUDA device unless ``--device cpu`` is given.  Weights are
random, drawn from ``--seed`` with a ``torch.Generator`` on the device;
prompts come from ``numpy.random.default_rng(seed)``, and after them, for
the VLM and encoder-decoder families, the context embeddings the stub
frontend would give (``normal(size=(batch, n_context_tokens, d_model)) *
0.02`` in bfloat16, as the reference draws them), which ``lm_prefill``
takes as ``cross_src``; temperature sampling draws from its own seeded
``torch.Generator``.  The last line counts the kernel launches of the
run (``decode_attention`` once per self-attention layer per decode step on
the card; ``ssd_scan`` once per Mamba layer per prefill; none on the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.block_attention import decode_attention
from repro_torch.kernels.ssd import ssd_scan
from repro_torch.models.lm import init_lm, lm_decode, lm_prefill
from repro_torch.runtime import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; >0 = temperature sampling")
    ap.add_argument("--top-k", type=int, default=0, help="top-k filter (0=off)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, tp=1)  # one card: each KV head stored once, vocab unpadded
    model = init_lm(cfg, generator=torch.Generator(device).manual_seed(args.seed),
                    device=device)
    max_seq = args.prompt_len + args.gen

    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, size=(args.batch, args.prompt_len)), device=device)
    ctx = None
    if cfg.family in ("vlm", "encdec"):  # the stub frontends' patch / frame embeddings
        ctx = torch.as_tensor(
            rng.normal(size=(args.batch, cfg.n_context_tokens, cfg.d_model)) * 0.02,
            dtype=torch.bfloat16, device=device)
    sampler = torch.Generator(device).manual_seed(args.seed + 1)

    def pick(logits):
        lv = logits[:, : cfg.vocab].float()
        if args.temperature <= 0:
            return torch.argmax(lv, -1)
        lv = lv / args.temperature
        if args.top_k > 0:
            kth = torch.sort(lv, dim=-1).values[:, -args.top_k][:, None]
            lv = torch.where(lv < kth, float("-inf"), lv)
        return torch.multinomial(torch.softmax(lv, -1), 1, generator=sampler)[:, 0]

    launched = (decode_attention.launches, ssd_scan.launches)
    t0 = time.perf_counter()
    logits, caches = lm_prefill(model, prompts, cross_src=ctx, max_seq=max_seq)
    _sync(device)
    t1 = time.perf_counter()

    tok = pick(logits)
    out_tokens = [tok]
    for i in range(args.gen - 1):
        logits, caches = lm_decode(model, caches, tok, args.prompt_len + i)
        tok = pick(logits)
        out_tokens.append(tok)
    _sync(device)
    t2 = time.perf_counter()

    gen = torch.stack(out_tokens, 1).cpu().numpy()
    launches = {"decode_attention": decode_attention.launches - launched[0],
                "ssd_scan": ssd_scan.launches - launched[1]}
    print(f"{cfg.name} on {device}: prefill {args.batch}x{args.prompt_len} tokens in "
          f"{t1 - t0:.2f}s")
    print(f"decode: {args.batch}x{args.gen} tokens in {t2 - t1:.2f}s "
          f"({args.batch * args.gen / (t2 - t1):.1f} tok/s)")
    print("sample generations (token ids):")
    for row in gen[:2]:
        print(" ", row[:16].tolist())
    print(f"kernel launches: decode_attention {launches['decode_attention']}, ssd_scan "
          f"{launches['ssd_scan']} ({args.gen - 1} decode steps)")
    return {"tokens": gen, "prefill_s": t1 - t0, "decode_s": t2 - t1, "launches": launches}


if __name__ == "__main__":
    main()
