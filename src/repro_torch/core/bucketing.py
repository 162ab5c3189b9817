"""Streaming-relation protocol (``repro.core.bucketing``'s base classes).

Only the ``ChunkSource`` protocol and its in-memory ``ArraySource`` are
ported so far; the out-of-core bucketing backend itself is later work.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


class ChunkSource:
    """Minimal streaming-relation protocol."""

    def chunks(self, chunk_rows: int) -> Iterator[np.ndarray]:
        raise NotImplementedError

    @property
    def num_rows(self) -> int:
        raise NotImplementedError

    @property
    def num_cols(self) -> int:
        raise NotImplementedError

    def gather(self, mask_fn, chunk_rows: int) -> np.ndarray:
        """Materialise the rows where mask_fn(chunk) is True (one pass)."""
        parts = [c[mask_fn(c)] for c in self.chunks(chunk_rows)]
        return np.concatenate(parts, axis=0) if parts else \
            np.zeros((0, self.num_cols))


class ArraySource(ChunkSource):
    def __init__(self, X: np.ndarray):
        self.X = X

    def chunks(self, chunk_rows: int) -> Iterator[np.ndarray]:
        for i in range(0, len(self.X), chunk_rows):
            yield np.asarray(self.X[i:i + chunk_rows], np.float64)

    @property
    def num_rows(self) -> int:
        return self.X.shape[0]

    @property
    def num_cols(self) -> int:
        return self.X.shape[1]
