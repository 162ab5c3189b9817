"""Training driver: data pipeline + train_step + checkpointing + fault
tolerance, for any ``--arch`` (full or -smoke reduced configs); port of
``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 50 --batch 8 --seq 2048 --ckpt-dir build/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch smollm-135m-smoke --device cpu --steps 50 --batch 8 --seq 128

The reference's flags and control flow, plus ``--device`` (default
``cuda``; the CPU runs only with ``--device cpu``).  The initial
parameters are drawn from ``torch.Generator(device).manual_seed(0)``.
Failure injection (``--fail-at``) exercises the restore path end to end:
the run exits with code 42 after that step and, relaunched with the same
flags, resumes from the latest atomic checkpoint and replays the same
batch sequence.  A restore installs the saved parameters in the model
(``Model.load_params``), so the model's inference entries see them too.
``--select-data`` runs the package-query data selection first, on the
same device, and prints it; as in the reference, the run then trains on
the synthetic tokens without it.

A step's time is taken after its loss is read back (the step is eager,
so the read is where its device work ends): the coordinator's straggler
rule sees each step's whole time.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.data.selection import (CorpusSpec, selection_query,
                                        select_training_docs, synth_corpus)
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.runtime import Coordinator
from repro_torch.training.optimizer import OptHyper
from repro_torch.training.step import init_train_state, make_train_step


# --select-data's partitioning of the corpus (the reference's values)
SELECT_KW = dict(d_f=20, alpha=2000)


def selection_problem():
    """--select-data's corpus and package query."""
    corpus = synth_corpus(CorpusSpec(num_docs=20_000))
    return corpus, selection_query(corpus, token_budget=2e6,
                                   domain_caps={"web": 1.2e6},
                                   dup_budget=50.0)


def main(argv=None, stats: Optional[dict] = None):
    """Runs the flags ``argv``; returns the losses of the steps this run
    took.  ``stats`` (optional dict) receives what the run measured, also
    when it ends by ``--fail-at``'s ``SystemExit``: ``steps`` (a
    ``(step, loss, seconds)`` per step), ``saves`` (``(step, seconds,
    path)`` per checkpoint), ``restore_s`` and ``start`` (the step it
    resumed at), ``model`` (the trained ``Model``), and ``selection`` and
    ``selection_s`` with ``--select-data``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m-smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a crash after this step (tests restart)")
    ap.add_argument("--select-data", action="store_true",
                    help="run package-query data selection first")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    stats = {} if stats is None else stats
    stats.update(steps=[], saves=[])

    cfg = get_config(args.arch)
    model = Model(cfg, device=device)
    stats["model"] = model
    print(f"[train] arch={cfg.name} params={model.param_count()/1e6:.2f}M "
          f"device={device}")

    if args.select_data:
        t0 = time.perf_counter()
        corpus, q = selection_problem()
        sel = select_training_docs(corpus, q, device=device, **SELECT_KW)
        stats.update(selection=sel, selection_s=time.perf_counter() - t0)
        print(f"[train] data selection: feasible={sel.feasible} "
              f"docs={len(sel.idx)} quality={sel.obj:.1f}")

    data = SyntheticTokens(DataConfig(cfg.vocab_size, args.seq, args.batch))
    hyper = OptHyper(lr=args.lr, warmup_steps=max(args.steps // 10, 5),
                     total_steps=args.steps)
    step_fn = make_train_step(model, hyper, microbatches=args.microbatches,
                              compress=args.compress_grads)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    coord = Coordinator(num_workers=1, ckpt_cadence_steps=args.ckpt_every)

    state = init_train_state(model,
                             torch.Generator(device=device).manual_seed(0),
                             compress=args.compress_grads)
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        t0 = time.perf_counter()
        restored = ckpt.restore(state)
        model.load_params(restored["params"])
        model.requires_grad_(True)
        state = {"params": model.params, "opt": restored["opt"]}
        del restored
        start = int(state["opt"]["step"])
        stats["restore_s"] = time.perf_counter() - t0
        print(f"[train] resumed from checkpoint at step {start}")
    stats["start"] = start

    losses = []
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        batch = {k: torch.as_tensor(v, device=device) for k, v in
                 data.global_batch(step).items()}
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        coord.heartbeat(0, time.time())
        coord.report_step(0, time.time(), dt)
        losses.append(loss)
        stats["steps"].append((step, loss, dt))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step:4d} loss={loss:.4f} "
                  f"ce={float(metrics['ce']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} {dt:.2f}s",
                  flush=True)
        if ckpt and coord.should_checkpoint(step + 1):
            _save(ckpt, step + 1, state, stats)
        if args.fail_at == step:
            print(f"[train] injected failure at step {step}", flush=True)
            raise SystemExit(42)
    if ckpt:
        _save(ckpt, args.steps, state, stats)
    if losses:
        print(f"[train] done. loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


def _save(ckpt: CheckpointManager, step: int, state, stats: dict) -> None:
    t0 = time.perf_counter()
    path = ckpt.save(step, state)
    stats["saves"].append((step, time.perf_counter() - t0, path))


if __name__ == "__main__":
    main()
