"""Deterministic sharded synthetic-token pipeline (port of
``repro.data.pipeline``: numpy only, copied, so its batches are the
reference's bit for bit; the launcher moves a batch to its device).

Every (shard, step) pair maps to a unique seed, so a restarted/re-sharded
job replays the exact same global batch order — the property the
fault-tolerance path relies on (resume from checkpoint step k reproduces
batch k+1 regardless of the new mesh width).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticTokens:
    """Markov-ish synthetic LM data (not uniform noise: next-token has
    structure so the loss actually decreases during the example runs)."""

    def __init__(self, cfg: DataConfig, selected_docs: Optional[np.ndarray] = None):
        self.cfg = cfg
        self.selected = selected_docs
        base = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        self._proj = base.integers(0, v, size=4096).astype(np.int64)

    def _gen_doc(self, rng: np.random.Generator, length: int) -> np.ndarray:
        v = self.cfg.vocab_size
        toks = np.empty(length, np.int64)
        toks[0] = rng.integers(1, v)
        for i in range(1, length):
            if rng.random() < 0.7:   # structured transition
                toks[i] = self._proj[toks[i - 1] % 4096] % v
            else:
                toks[i] = rng.integers(1, v)
        return toks

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        B, S = self.cfg.global_batch, self.cfg.seq_len
        out = np.empty((B, S + 1), np.int64)
        for b in range(B):
            rng = np.random.default_rng(
                (self.cfg.seed, step, b, 0xD1CE))
            out[b] = self._gen_doc(rng, S + 1)
        return {"tokens": out[:, :-1].astype(np.int32),
                "labels": out[:, 1:].astype(np.int32)}

    def shard_batch(self, step: int, shard: int, num_shards: int
                    ) -> Dict[str, np.ndarray]:
        g = self.global_batch(step)
        per = self.cfg.global_batch // num_shards
        sl = slice(shard * per, (shard + 1) * per)
        return {k: v[sl] for k, v in g.items()}
