"""``Relation``: the named-column table every layer consumes (resident part).

Ports the in-memory half of ``repro.core.relation``: the :class:`Relation`
contract (``chunks``, ``gather_rows``, dict-style column access),
:class:`ArrayRelation` (every dict-of-arrays table, zero copy),
:func:`as_relation` and :func:`gather_column`.  Streamed relations
(memmap, ChunkSource scans, transient-read retries) are later work.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.bucketing import ArraySource, ChunkSource

DEFAULT_CHUNK_ROWS = 1 << 18


def _normalize_idx(idx, num_rows: int) -> np.ndarray:
    """Row selector -> validated int64 id array: boolean masks become
    ``flatnonzero``, negative / out-of-range ids raise."""
    idx = np.asarray(idx)
    if idx.dtype == bool:
        if idx.shape != (num_rows,):
            raise IndexError(f"boolean mask of shape {idx.shape} over "
                             f"{num_rows} rows")
        return np.flatnonzero(idx)
    idx = idx.astype(np.int64, copy=False)
    if len(idx):
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0:
            raise IndexError(f"negative row id {lo}")
        if hi >= num_rows:
            raise IndexError(f"row id {hi} >= {num_rows}")
    return idx


class Relation:
    """Named-column, chunk-scanned table."""

    columns: Tuple[str, ...] = ()
    in_memory: bool = False
    chunk_rows: int = DEFAULT_CHUNK_ROWS

    @property
    def num_rows(self) -> int:
        raise NotImplementedError

    def chunks(self, names: Optional[Sequence[str]] = None,
               chunk_rows: Optional[int] = None) -> Iterator[np.ndarray]:
        """Stream ``(n_i, len(names))`` float64 blocks in row order."""
        raise NotImplementedError

    def gather_rows(self, idx: np.ndarray,
                    names: Optional[Sequence[str]] = None
                    ) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def _cols(self, names: Optional[Sequence[str]]) -> Tuple[str, ...]:
        if names is None:
            return tuple(self.columns)
        missing = [n for n in names if n not in self.columns]
        if missing:
            raise KeyError(f"unknown column(s) {missing}; have "
                           f"{list(self.columns)}")
        return tuple(names)

    def column(self, name: str):
        raise NotImplementedError

    def __getitem__(self, name: str):
        return self.column(name)

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def keys(self):
        return tuple(self.columns)

    def gather_matrix(self, idx: np.ndarray,
                      names: Optional[Sequence[str]] = None) -> np.ndarray:
        names = self._cols(names)
        view = self.gather_rows(idx, names)
        return np.stack([view[nm] for nm in names], axis=1)

    def chunk_source(self, names: Optional[Sequence[str]] = None,
                     chunk_rows: Optional[int] = None) -> ChunkSource:
        """This relation's columns as a ChunkSource."""
        names = self._cols(names)
        return ArraySource(np.stack([np.asarray(self[nm], np.float64)
                                     for nm in names], axis=1))


class ArrayRelation(Relation):
    """Every dict-of-arrays table is a Relation (zero-copy adapter)."""

    in_memory = True

    def __init__(self, table: Dict[str, np.ndarray]):
        self._table = {k: np.asarray(v) for k, v in table.items()}
        self.columns = tuple(self._table)
        lens = {len(v) for v in self._table.values()}
        if len(lens) > 1:
            raise ValueError(f"ragged columns: {lens}")

    @property
    def num_rows(self) -> int:
        return len(next(iter(self._table.values()))) if self._table else 0

    def column(self, name: str) -> np.ndarray:
        return self._table[name]

    def chunks(self, names=None, chunk_rows=None) -> Iterator[np.ndarray]:
        names = self._cols(names)
        step = chunk_rows or self.chunk_rows
        n = self.num_rows
        for a in range(0, n, step):
            b = min(a + step, n)
            yield np.stack([np.asarray(self._table[nm][a:b], np.float64)
                            for nm in names], axis=1)

    def gather_rows(self, idx, names=None) -> Dict[str, np.ndarray]:
        names = self._cols(names)
        idx = _normalize_idx(idx, self.num_rows)
        return {nm: np.asarray(self._table[nm], np.float64)[idx]
                for nm in names}


def as_relation(obj, columns: Optional[Sequence[str]] = None) -> Relation:
    """Coerce a table-ish object to a Relation (dict -> ArrayRelation;
    Relations pass through).  ``columns`` is accepted for call-site parity
    with the reference; streamed sources are not ported yet."""
    if isinstance(obj, Relation):
        return obj
    if isinstance(obj, dict):
        return ArrayRelation(obj)
    raise TypeError(f"cannot make a Relation from {type(obj).__name__} "
                    "(streamed relations are not ported yet)")


def gather_column(table, name: str, idx: np.ndarray) -> np.ndarray:
    """One column at ``idx`` (int ids or a boolean mask) for a dict table
    OR a Relation."""
    idx = np.asarray(idx)
    if isinstance(table, Relation) and not table.in_memory:
        return table.gather_rows(idx, (name,))[name]
    return np.asarray(table[name], np.float64)[idx]
