"""Serving driver: package-query admission control + batched generation.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        [--device cuda] [--requests 24] [--ticks 6]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch mixtral-8x22b-smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v3-671b --layers 5      # one 80 GB card

The reference's flags, plus ``--device`` (default ``cuda``; the CPU runs
only with ``--device cpu``) and ``--layers`` (the model cut to its first
layers, at full width, where the whole depth does not fit the card: a
``first_k_dense`` arch keeps at least one layer of its main stack).  The
model is randomly initialised from a seeded ``torch.Generator``.  The HBM
budget of the admission query is ``--hbm-frac`` of the card's memory; on
the CPU it is that share of the 16 GiB the reference assumes.
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
        if not cfg.first_k_dense < args.layers <= cfg.num_layers:
            raise ValueError(f"--layers {args.layers}: {cfg.name} takes "
                             f"{cfg.first_k_dense + 1}..{cfg.num_layers}")
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
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
