"""Out-of-core ``Relation``: the streamed table every layer consumes (port
of ``repro.core.relation``).

* :class:`Relation` -- a named-column table backed by chunked scans:
  ``chunks()`` streams ``(n_i, k)`` blocks for a subset of columns,
  ``gather_rows(idx)`` materialises an arbitrary index subset (sorted-index
  gather in chunk order, result restored to the caller's order), and
  ``reduce_columns`` folds a streamed per-column reduction.  ``rel[name]``
  gives dict-style column access: in-memory relations hand back the real
  array, out-of-core ones a :class:`LazyColumn` that gathers on fancy
  indexing but refuses whole-column materialisation.
* :class:`ArrayRelation` -- every dict-of-arrays table (zero copy).
* :class:`MemmapRelation` -- an on-disk ``(n, k)`` ``.npy`` / raw-binary
  matrix with named columns; ``gather_rows`` fancy-indexes the memmap on
  the sorted ids so only touched pages are read.
* :class:`SourceRelation` -- any ``ChunkSource`` scan, columns named.

Disk reads retry transient ``OSError``s with capped, seeded exponential
backoff (:func:`configure_retries`, :func:`io_retry_count`).  Every
materialisation (chunk, gather, bucket) calls :func:`note_resident`, and
:func:`peak_resident_rows` is the largest one since the last
:func:`reset_peak_resident`: the bar that an out-of-core solve held only
O(alpha + memory_rows) rows.  :class:`CountingSource` counts full
streaming passes.  The reference's fault-injection hooks in the reads are
not ported yet.  All of this is host numpy, as in the reference.
"""
from __future__ import annotations

import time
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.bucketing import ArraySource, ChunkSource, MemmapSource

DEFAULT_CHUNK_ROWS = 1 << 18

# ------------------------------------------------------------- retried I/O

# Transient read faults (flaky disk / network filesystem) are retried with
# capped exponential backoff before they surface.  The jitter rng is
# seeded so a replayed run sleeps the same schedule.
_RETRY = {"tries": 4, "base_s": 0.02, "max_s": 1.0, "seed": 0}
_RETRY_STATS = {"retries": 0}


def io_retry_count() -> int:
    """Process-wide count of transient-read retries (all relations);
    ``engine.solve`` diffs it around a solve to fill
    ``SolveReport.fault_retries``."""
    return _RETRY_STATS["retries"]


def configure_retries(*, tries: Optional[int] = None,
                      base_s: Optional[float] = None,
                      max_s: Optional[float] = None,
                      seed: Optional[int] = None) -> Dict[str, float]:
    """Tune the transient-I/O retry policy (None keeps the current value);
    returns the policy now in force.  ``tries`` counts total attempts, so
    ``tries=1`` disables retrying."""
    if tries is not None:
        _RETRY["tries"] = max(1, int(tries))
    if base_s is not None:
        _RETRY["base_s"] = float(base_s)
    if max_s is not None:
        _RETRY["max_s"] = float(max_s)
    if seed is not None:
        _RETRY["seed"] = int(seed)
    return dict(_RETRY)


def _backoff_sleep(attempt: int, rng: np.random.Generator) -> None:
    """Sleep ``min(max_s, base_s * 2^attempt)`` scaled by seeded jitter in
    [0.5, 1.5) -- capped exponential backoff."""
    delay = min(_RETRY["max_s"], _RETRY["base_s"] * (2.0 ** attempt))
    time.sleep(delay * (0.5 + rng.random()))


def _retry_io(fn, what: str):
    """Run ``fn()``; transient ``OSError`` retries up to ``tries`` total
    attempts with capped exponential backoff, then re-raises annotated."""
    tries = int(_RETRY["tries"])
    rng = np.random.default_rng(_RETRY["seed"])
    for k in range(tries):
        try:
            return fn()
        except OSError as e:
            if k == tries - 1:
                raise OSError(f"{what}: giving up after {tries} "
                              f"attempts ({e})") from e
            _RETRY_STATS["retries"] += 1
            _backoff_sleep(k, rng)

# ------------------------------------------------------ resident tracking


_PEAK = {"rows": 0}


def note_resident(rows: int) -> None:
    """Record a materialisation of ``rows`` rows (chunk, gather, bucket)."""
    if rows > _PEAK["rows"]:
        _PEAK["rows"] = int(rows)


def peak_resident_rows() -> int:
    return _PEAK["rows"]


def reset_peak_resident() -> None:
    _PEAK["rows"] = 0


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


# -------------------------------------------------------------- lazy column


class LazyColumn:
    """A named column of an out-of-core Relation.

    Supports ``len`` and fancy ``__getitem__`` (one gather per call); any
    attempt to materialise the whole column (``np.asarray``) raises so a
    1e9-row column can never silently become resident.
    """

    def __init__(self, rel: "Relation", name: str):
        self._rel = rel
        self._name = name

    def __len__(self) -> int:
        return self._rel.num_rows

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            idx = np.arange(*idx.indices(self._rel.num_rows))
        arr = np.asarray(idx)
        sel = arr if arr.dtype == bool else np.atleast_1d(arr).ravel()
        out = self._rel.gather_rows(sel, (self._name,))[self._name]
        return float(out[0]) if arr.ndim == 0 else out

    def __array__(self, dtype=None, copy=None):
        raise RuntimeError(
            f"refusing to materialise out-of-core column {self._name!r} "
            f"({self._rel.num_rows} rows); use gather_rows(idx) / chunks() "
            "to stay candidate-resident")


# ----------------------------------------------------------------- Relation


class Relation:
    """Named-column, chunk-scanned table (see module docstring)."""

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

    def _cols(self, names: Optional[Sequence[str]]) -> Tuple[str, ...]:
        if names is None:
            return tuple(self.columns)
        missing = [n for n in names if n not in self.columns]
        if missing:
            raise KeyError(f"unknown column(s) {missing}; have "
                           f"{list(self.columns)}")
        return tuple(names)

    def column(self, name: str):
        """Dict-style column access; lazy for out-of-core relations."""
        self._cols((name,))
        return LazyColumn(self, name)

    def __getitem__(self, name: str):
        return self.column(name)

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def keys(self):
        return tuple(self.columns)

    def gather_rows(self, idx: np.ndarray,
                    names: Optional[Sequence[str]] = None
                    ) -> Dict[str, np.ndarray]:
        """Materialise the rows ``idx`` (any order, duplicates allowed).

        Generic path: one streaming pass, gathering each chunk's members of
        ``sort(idx)`` in chunk order, then the result is un-sorted back to
        the caller's order -- O(n/chunk) scan I/O, O(|idx|) resident.
        """
        names = self._cols(names)
        idx = _normalize_idx(idx, self.num_rows)
        order = np.argsort(idx, kind="stable")
        sidx = idx[order]
        out = np.empty((len(idx), len(names)), np.float64)
        base = 0
        lo = 0
        for chunk in self.chunks(names):
            nb = len(chunk)
            hi = lo + np.searchsorted(sidx[lo:], base + nb)
            if hi > lo:
                out[order[lo:hi]] = chunk[sidx[lo:hi] - base]
                lo = hi
            base += nb
            if lo >= len(sidx):
                break
        if lo < len(sidx):
            raise IndexError(f"row ids out of range: {sidx[lo]} >= {base}")
        note_resident(len(idx))
        return {nm: out[:, j] for j, nm in enumerate(names)}

    def gather_matrix(self, idx: np.ndarray,
                      names: Optional[Sequence[str]] = None) -> np.ndarray:
        names = self._cols(names)
        view = self.gather_rows(idx, names)
        return np.stack([view[nm] for nm in names], axis=1)

    def reduce_columns(self, names: Optional[Sequence[str]], chunk_fn,
                       combine, init=None):
        """Streamed per-column reduction: fold ``combine(acc,
        chunk_fn(block))`` over all chunks (``acc`` starts as ``init`` or
        the first chunk's value)."""
        acc = init
        first = init is None
        for chunk in self.chunks(names):
            v = chunk_fn(chunk)
            acc = v if first else combine(acc, v)
            first = False
        return acc

    def chunk_source(self, names: Optional[Sequence[str]] = None,
                     chunk_rows: Optional[int] = None) -> ChunkSource:
        """This relation's columns as a bucketing-protocol ChunkSource."""
        return _RelationSource(self, self._cols(names),
                               chunk_rows or self.chunk_rows)


class _RelationSource(ChunkSource):
    """ChunkSource over a fixed column subset of a Relation."""

    def __init__(self, rel: Relation, names: Tuple[str, ...],
                 chunk_rows: int):
        self.rel = rel
        self.names = names
        self.chunk_rows = chunk_rows

    def chunks(self, chunk_rows: int) -> Iterator[np.ndarray]:
        return self.rel.chunks(self.names, chunk_rows)

    @property
    def num_rows(self) -> int:
        return self.rel.num_rows

    @property
    def num_cols(self) -> int:
        return len(self.names)


# ------------------------------------------------------------ ArrayRelation


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
        note_resident(len(idx))
        return {nm: np.asarray(self._table[nm], np.float64)[idx]
                for nm in names}


# ----------------------------------------------------------- MemmapRelation


class MemmapRelation(Relation):
    """On-disk ``(n, k)`` matrix with named columns (the container-scale
    stand-in for the paper's PostgreSQL heap file)."""

    in_memory = False

    def __init__(self, X: np.ndarray, columns: Sequence[str],
                 chunk_rows: int = DEFAULT_CHUNK_ROWS):
        if X.ndim != 2 or X.shape[1] != len(columns):
            raise ValueError(f"need (n, {len(columns)}) data, got {X.shape}")
        self.X = X
        self.columns = tuple(columns)
        self.chunk_rows = chunk_rows

    @classmethod
    def from_npy(cls, path: str, columns: Sequence[str],
                 chunk_rows: int = DEFAULT_CHUNK_ROWS) -> "MemmapRelation":
        return cls(np.lib.format.open_memmap(path, mode="r"), columns,
                   chunk_rows)

    @classmethod
    def from_raw(cls, path: str, columns: Sequence[str], *, rows: int,
                 dtype=np.float64, offset: int = 0,
                 chunk_rows: int = DEFAULT_CHUNK_ROWS) -> "MemmapRelation":
        """Headerless binary file: row-major (rows, len(columns))."""
        X = np.memmap(path, dtype=dtype, mode="r", offset=offset,
                      shape=(rows, len(columns)))
        return cls(X, columns, chunk_rows)

    @property
    def num_rows(self) -> int:
        return self.X.shape[0]

    def _col_idx(self, names: Tuple[str, ...]) -> np.ndarray:
        pos = {nm: j for j, nm in enumerate(self.columns)}
        return np.asarray([pos[nm] for nm in names], np.int64)

    def _all_columns(self, cj: np.ndarray) -> bool:
        return len(cj) == len(self.columns) and \
            np.array_equal(cj, np.arange(len(self.columns)))

    def chunks(self, names=None, chunk_rows=None) -> Iterator[np.ndarray]:
        names = self._cols(names)
        cj = self._col_idx(names)
        step = chunk_rows or self.chunk_rows
        full = self._all_columns(cj)
        for a in range(0, self.num_rows, step):
            b = min(a + step, self.num_rows)
            block = _retry_io(
                lambda a=a, b=b: np.asarray(self.X[a:b], np.float64),
                f"chunk read [{a}:{b})")
            note_resident(b - a)
            yield block if full else block[:, cj]

    def gather_rows(self, idx, names=None) -> Dict[str, np.ndarray]:
        """Sorted-index gather: only the touched memmap pages are read."""
        names = self._cols(names)
        cj = self._col_idx(names)
        idx = _normalize_idx(idx, self.num_rows)
        order = np.argsort(idx, kind="stable")
        rows = np.empty((len(idx), len(self.columns)), np.float64)
        rows[order] = _retry_io(lambda: self.X[idx[order]],
                                f"gather of {len(idx)} rows")
        note_resident(len(idx))
        return {nm: rows[:, cj[j]] for j, nm in enumerate(names)}

    def chunk_source(self, names=None, chunk_rows=None) -> ChunkSource:
        names = self._cols(names)
        if self._all_columns(self._col_idx(names)):
            src = MemmapSource.__new__(MemmapSource)
            src.X = self.X
            return src
        return super().chunk_source(names, chunk_rows)


# ----------------------------------------------------------- SourceRelation


class SourceRelation(Relation):
    """Any ``ChunkSource`` scan is a Relation once its columns are named."""

    in_memory = False

    def __init__(self, source: ChunkSource, columns: Sequence[str],
                 chunk_rows: int = DEFAULT_CHUNK_ROWS):
        if source.num_cols != len(columns):
            raise ValueError(f"source has {source.num_cols} cols, "
                             f"{len(columns)} names given")
        self.source = source
        self.columns = tuple(columns)
        self.chunk_rows = chunk_rows

    @property
    def num_rows(self) -> int:
        return self.source.num_rows

    def chunks(self, names=None, chunk_rows=None) -> Iterator[np.ndarray]:
        """Resilient scan: a transient ``OSError`` mid-stream restarts the
        source and skips the rows already delivered (a generator that
        raised cannot be resumed), with the same capped backoff as
        :func:`_retry_io`; rows are yielded exactly once."""
        names = self._cols(names)
        pos = {nm: j for j, nm in enumerate(self.columns)}
        cj = np.asarray([pos[nm] for nm in names], np.int64)
        full = np.array_equal(cj, np.arange(len(self.columns)))
        step = chunk_rows or self.chunk_rows
        tries = int(_RETRY["tries"])
        rng = np.random.default_rng(_RETRY["seed"])
        delivered = 0
        failures = 0
        while True:
            gen = self.source.chunks(step)
            skip = delivered
            try:
                for block in gen:
                    nb = len(block)
                    if skip >= nb:
                        skip -= nb
                        continue
                    if skip:
                        block = block[skip:]
                        skip = 0
                    delivered += len(block)
                    note_resident(len(block))
                    yield block if full else block[:, cj]
                return
            except OSError as e:
                failures += 1
                if failures >= tries:
                    raise OSError(f"source scan: giving up after "
                                  f"{failures} attempts at row "
                                  f"{delivered} ({e})") from e
                _RETRY_STATS["retries"] += 1
                _backoff_sleep(failures - 1, rng)
            finally:
                close = getattr(gen, "close", None)
                if close is not None:
                    close()


# -------------------------------------------------------------- conversion


def as_relation(obj, columns: Optional[Sequence[str]] = None) -> Relation:
    """Coerce a table-ish object to a Relation.

    dict-of-arrays -> :class:`ArrayRelation`; ChunkSource -> a
    :class:`SourceRelation` (``columns`` required, or a 2-D array source
    becomes a :class:`MemmapRelation`); Relations pass through.
    """
    if isinstance(obj, Relation):
        return obj
    if isinstance(obj, ChunkSource):
        if columns is None:
            raise ValueError("need column names to wrap a ChunkSource")
        if isinstance(obj, ArraySource) and hasattr(obj, "X") and \
                getattr(obj.X, "ndim", 0) == 2:
            return MemmapRelation(obj.X, columns)
        return SourceRelation(obj, columns)
    if isinstance(obj, dict):
        return ArrayRelation(obj)
    raise TypeError(f"cannot make a Relation from {type(obj).__name__}")


def gather_column(table, name: str, idx: np.ndarray) -> np.ndarray:
    """One column at ``idx`` (int ids or a boolean mask) for a dict table
    OR a Relation (shared by the shading / neighbor candidate paths)."""
    idx = np.asarray(idx)
    if isinstance(table, Relation) and not table.in_memory:
        return table.gather_rows(idx, (name,))[name]
    return np.asarray(table[name], np.float64)[idx]


# --------------------------------------------------------- pass accounting


class CountingSource(ChunkSource):
    """Wraps a ChunkSource and counts full streaming passes + rows read --
    the instrument showing that the bucketed build is O(1) passes."""

    def __init__(self, inner: ChunkSource):
        self.inner = inner
        self.passes = 0
        self.rows_read = 0

    def chunks(self, chunk_rows: int) -> Iterator[np.ndarray]:
        self.passes += 1
        for c in self.inner.chunks(chunk_rows):
            self.rows_read += len(c)
            yield c

    @property
    def num_rows(self) -> int:
        return self.inner.num_rows

    @property
    def num_cols(self) -> int:
        return self.inner.num_cols
