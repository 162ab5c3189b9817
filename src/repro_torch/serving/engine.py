"""Serving engine (port of ``repro.serving.engine``): batched prefill and
decode around ``Model.decode_step``.

The host-side loop that feeds the model: batch assembly from the
``PackageScheduler``, the KV cache, greedy or temperature sampling.  As in
the reference, a prompt is prefilled by stepping the decoder over it (the
parallel forward is ``Model.prefill_logits``).  The cache index stays a
host int, so the loop reads back from the device only the sampled tokens,
one read per token.  Temperature sampling draws from the engine's own
``torch.Generator`` under its lock.  ``serve`` records one ``TickStats``
per tick on ``tick_log``.  Generation and ``serve`` run under
``torch.no_grad()``, so a model whose parameters require grad (one being
trained) serves without building graphs.  An encoder-decoder decodes against the zero
cross cache of ``Model.init_cache`` and a VLM without its prefix: the
reference's ``generate_batch`` runs neither the encoder nor the vision
stub.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.serving.scheduler import PackageScheduler


@dataclasses.dataclass
class Generation:
    rid: int
    tokens: List[int]


@dataclasses.dataclass
class TickStats:
    """One ``serve`` tick: the admission and the batch it generated.
    ``prefill_s`` runs from the first prompt step to the read of the first
    sampled token (time to first token); ``decode_s`` covers the remaining
    ``steps - 1`` tokens."""
    admitted: int
    solve_s: float
    status: Optional[str]
    prompt_len: int = 0
    steps: int = 0
    tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0


class ServingEngine:

    # concurrent generate_batch calls draw from the one generator under
    # the lock, so each draw is a distinct step of its stream
    __guarded_by__ = {"generator": "_lock"}

    def __init__(self, model: Model, *, cache_len: int = 512, seed: int = 0):
        self.model = model
        self.cfg = model.cfg
        self.cache_len = cache_len
        self.generator = torch.Generator(device=model.device).manual_seed(seed)
        self._lock = threading.Lock()
        self.tick_log: List[TickStats] = []

    def _sample(self, logits: torch.Tensor,
                temperature: float) -> torch.Tensor:
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            with self._lock:
                tok = torch.multinomial(probs, 1,
                                        generator=self.generator)[:, 0]
        else:
            tok = logits.argmax(dim=-1)
        return tok.clamp(0, self.cfg.vocab_size - 1)

    @torch.no_grad()
    def _generate(self, prompts: np.ndarray, max_new: int,
                  temperature: float) -> Tuple[np.ndarray, float, float]:
        """(tokens (B, max_new) int32, prefill s, decode s)."""
        B, P = prompts.shape
        out = np.zeros((B, max_new), np.int32)
        if max_new == 0:
            return out, 0.0, 0.0
        cache = self.model.init_cache(B, self.cache_len)
        toks = torch.as_tensor(prompts, dtype=torch.long,
                               device=self.model.device)
        t0 = time.perf_counter()
        logits = None
        for t in range(P):
            logits, cache = self.model.decode_step(cache, toks[:, t:t + 1])
        t_first = t0
        for i in range(max_new):
            tok = self._sample(logits, temperature)
            out[:, i] = tok.cpu().numpy()        # the one read per token
            if i == 0:
                t_first = time.perf_counter()
            if i + 1 < max_new:
                logits, cache = self.model.decode_step(cache, tok[:, None])
        return out, t_first - t0, time.perf_counter() - t_first

    def generate_batch(self, prompts: np.ndarray, max_new: int,
                       temperature: float = 0.0) -> np.ndarray:
        """prompts: (B, P) ints -> (B, max_new) int32 greedy/temp samples."""
        return self._generate(np.asarray(prompts), max_new, temperature)[0]

    @torch.no_grad()
    def serve(self, scheduler: PackageScheduler, *, ticks: int,
              pad_token: int = 0) -> List[Generation]:
        """Run admission ticks; each admitted batch is generated jointly."""
        done: List[Generation] = []
        for _ in range(ticks):
            t0 = time.perf_counter()
            batch = scheduler.tick()
            solve_s = time.perf_counter() - t0
            report = scheduler.last_report
            status = report.status if report is not None else None
            if not batch:
                self.tick_log.append(TickStats(0, solve_s, status))
                continue
            P = max(r.prompt_tokens for r in batch)
            new = max(r.max_new_tokens for r in batch)
            prompts = np.full((len(batch), P), pad_token, np.int32)
            for i, r in enumerate(batch):
                rng = np.random.default_rng(r.rid)
                prompts[i, -r.prompt_tokens:] = rng.integers(
                    1, self.cfg.vocab_size, r.prompt_tokens)
            gen, prefill_s, decode_s = self._generate(prompts, new, 0.0)
            for i, r in enumerate(batch):
                done.append(Generation(r.rid,
                                       gen[i, :r.max_new_tokens].tolist()))
            self.tick_log.append(TickStats(
                len(batch), solve_s, status, P, new,
                sum(r.max_new_tokens for r in batch), prefill_s, decode_s))
        return done
