"""Serving driver: package-query admission control + batched generation.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        [--device cuda] [--requests 24] [--ticks 6]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch mixtral-8x22b-smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v3-671b --layers 5      # one 80 GB card
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-1.5-large-398b --layers 4  # one period of 4 sublayers
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b

The reference's flags, plus ``--device`` (default ``cuda``; the CPU runs
only with ``--device cpu``) and ``--layers`` (the model cut to its first
layers, at full width, where the whole depth does not fit the card: a
``first_k_dense`` arch keeps at least one layer of its main stack; a
hybrid arch takes whole periods, or one period cut to ``--layers``
sublayers where that keeps the attention sublayer on a dense FFN, see
``cut_layers``).  The
model is randomly initialised from a seeded ``torch.Generator``.  The HBM
budget of the admission query is ``--hbm-frac`` of the card's memory; on
the CPU it is that share of the 16 GiB the reference assumes.  As in the
reference's engine, whisper decodes against the zero cross cache of
``init_cache`` (no encoder runs) and paligemma decodes without its image
prefix.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.serving import PackageScheduler, Request, ServingEngine

CPU_MEMORY_BYTES = 16 * 2**30     # the reference's figure


def cut_layers(cfg, n: int):
    """``cfg`` cut to its first ``n`` layers at full width.  A hybrid arch
    keeps its layout when n is a multiple of ``attn_period``; below the
    period, n becomes the period (attention at sublayer n // 2) where that
    sublayer keeps a dense FFN.  Any other n raises ``ValueError``."""
    if not cfg.first_k_dense < n <= cfg.num_layers:
        raise ValueError(f"--layers {n}: {cfg.name} takes "
                         f"{cfg.first_k_dense + 1}..{cfg.num_layers}")
    if not cfg.is_hybrid or n % cfg.attn_period == 0:
        return dataclasses.replace(cfg, num_layers=n)
    attn_moe = bool(cfg.moe_period) and \
        (n // 2) % cfg.moe_period == cfg.moe_period - 1
    if n > cfg.attn_period or attn_moe:
        raise ValueError(
            f"--layers {n}: {cfg.name} takes a multiple of its period "
            f"{cfg.attn_period}, or one period of fewer sublayers whose "
            f"attention sublayer (index n // 2) has a dense FFN")
    return dataclasses.replace(cfg, num_layers=n, attn_period=n)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b-smoke")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--ticks", type=int, default=6)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--hbm-frac", type=float, default=0.05)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=None)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = cut_layers(cfg, args.layers)
    model = Model(cfg, device=dev).init(seed=0)
    print(f"[serve] arch={cfg.name} params={model.param_count()/1e6:.2f}M "
          f"device={dev}")

    memory = torch.cuda.get_device_properties(dev).total_memory \
        if dev.type == "cuda" else CPU_MEMORY_BYTES
    rng = np.random.default_rng(0)
    sched = PackageScheduler(
        cfg,
        hbm_budget_bytes=args.hbm_frac * memory,
        flop_budget=5e13,
        max_batch=args.max_batch, device=dev)
    for rid in range(args.requests):
        sched.submit(Request(
            rid=rid,
            prompt_tokens=int(rng.integers(4, 24)),
            max_new_tokens=int(rng.integers(4, 16)),
            priority=float(rng.uniform(0.1, 1.0))))

    engine = ServingEngine(model, cache_len=64)
    t0 = time.time()
    done = engine.serve(sched, ticks=args.ticks)
    dt = time.time() - t0
    print(f"[serve] completed {len(done)}/{args.requests} requests in "
          f"{dt:.1f}s over {args.ticks} ticks "
          f"(admitted={sched.admitted_total}, queued={len(sched.queue)})")
    for g in done[:3]:
        print(f"  rid={g.rid} tokens={g.tokens[:8]}...")
    return done


if __name__ == "__main__":
    main()
