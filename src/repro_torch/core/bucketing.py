"""Out-of-core DLV via the bucketing scheme -- paper Appendix D.2 (port of
``repro.core.bucketing``).

For relations that do not fit in memory (the paper's 10^9-tuple regime):

  1. one streaming pass estimates per-attribute mean/variance and the range
     of the highest-variance attribute (Chan's parallel Welford over
     chunks);
  2. the range is split into equal-width buckets, recursively until every
     bucket holds at most ``r`` tuples (r = in-memory budget) -- each
     refinement is one counting pass, the depth is bounded, and degenerate
     ranges (constant attribute, point masses) collapse to the
     oversized-bucket warning path instead of emitting phantom buckets;
  3. ONE further streaming pass spills every row into its bucket's scratch
     slice -- a bucket-major (n, k) scratch plus an (n,) global-row-id
     array, memmap-backed above ``spill_rows`` -- so the build reads the
     relation in O(1) full passes whatever the bucket count;
  4. Algorithm 6 (``dlv``, the batched-frontier rounds) runs per bucket on
     its contiguous scratch slice, on ``device``: each bucket reaches the
     card as one host-to-device copy, and the DLV scan and segment-stats
     kernels run on it there.  Group ids are offset into a global space.

Passes 1-3 and the merge are host numpy, as in the reference without a
mesh.  Buckets are disjoint half-open intervals on one attribute, so the
merged result is one :class:`~repro_torch.core.partitioner.Partition`: a
root split node holding the bucket edges whose children are the
per-bucket split trees.

The relation is consumed through the ``ChunkSource`` protocol (anything
yielding (n_i, k) arrays); ``MemmapSource`` adapts an on-disk ``.npy``
memmap (or, via :meth:`MemmapSource.from_raw`, a headerless binary file).
The reference's mesh-sharded stats passes are not ported yet.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import warnings
from typing import Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.dlv import dlv
from repro_torch.core.partitioner import (Partition, SplitTree, no_mesh,
                                          register_backend)
from repro_torch.device import resolve_device


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


class MemmapSource(ArraySource):
    """On-disk relation (np.memmap) -- rows stream through a fixed budget.

    Chunk reads touch disk, so they run through the transient-read retry
    of ``core.relation`` (capped exponential backoff) and poll the
    ``CHUNK_READ`` fault-injection site."""

    def chunks(self, chunk_rows: int) -> Iterator[np.ndarray]:
        from repro_torch.core.relation import _retry_io  # late: a cycle
        from repro_torch.runtime import faults
        for i in range(0, len(self.X), chunk_rows):

            def _read(i=i):
                faults.maybe_raise(faults.CHUNK_READ)
                return np.asarray(self.X[i:i + chunk_rows], np.float64)

            yield _retry_io(_read, f"memmap chunk [{i}:{i + chunk_rows})")

    def __init__(self, path: str, shape=None, dtype=None):
        self.X = np.lib.format.open_memmap(path, mode="r")
        if shape is not None and self.X.shape != tuple(shape):
            raise ValueError(f"{path}: stored shape {self.X.shape} != "
                             f"expected {tuple(shape)}")
        if dtype is not None and self.X.dtype != np.dtype(dtype):
            raise ValueError(f"{path}: stored dtype {self.X.dtype} != "
                             f"expected {np.dtype(dtype)}")

    @classmethod
    def from_raw(cls, path: str, shape, dtype=np.float64,
                 offset: int = 0) -> "MemmapSource":
        """Headerless row-major binary file (no .npy header)."""
        src = cls.__new__(cls)
        src.X = np.memmap(path, dtype=np.dtype(dtype), mode="r",
                          offset=offset, shape=tuple(shape))
        return src


@dataclasses.dataclass
class StreamStats:
    count: int
    mean: np.ndarray
    var: np.ndarray
    lo: np.ndarray
    hi: np.ndarray


def streaming_stats(src: ChunkSource, chunk_rows: int,
                    mesh=None) -> StreamStats:
    """One pass: per-attribute mean/var (Chan's parallel Welford) + range."""
    no_mesh("streaming_stats", mesh)
    count = 0
    mean = np.zeros(src.num_cols)
    m2 = np.zeros(src.num_cols)
    lo = np.full(src.num_cols, np.inf)
    hi = np.full(src.num_cols, -np.inf)
    for c in src.chunks(chunk_rows):
        nb = len(c)
        if nb == 0:
            continue
        mb = c.mean(axis=0)
        m2b = ((c - mb) ** 2).sum(axis=0)
        delta = mb - mean
        tot = count + nb
        mean = mean + delta * (nb / tot)
        m2 = m2 + m2b + delta ** 2 * (count * nb / tot)
        count = tot
        lo = np.minimum(lo, c.min(axis=0))
        hi = np.maximum(hi, c.max(axis=0))
    var = np.maximum(m2, 0.0) / max(count, 1)
    return StreamStats(count, mean, var, lo, hi)


# -------------------------------------------------------------- bucket edges


def _bucket_ids(col: np.ndarray, e: np.ndarray) -> np.ndarray:
    return np.clip(np.searchsorted(e, col, side="right") - 1, 0, len(e) - 2)


def _count_buckets(src: ChunkSource, attr: int, e: np.ndarray,
                   chunk_rows: int) -> np.ndarray:
    counts = np.zeros(len(e) - 1, np.int64)
    for c in src.chunks(chunk_rows):
        if len(c):
            counts += np.bincount(_bucket_ids(c[:, attr], e),
                                  minlength=len(counts))
    return counts


def _bucket_edges(src: ChunkSource, attr: int, lo: float, hi: float,
                  r: int, chunk_rows: int, max_depth: int = 8
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Equal-width edges refined until every bucket holds <= r rows.

    Returns ``(edges, counts)`` with counts exact for the returned edges.
    A constant attribute (lo == hi) yields one bucket, and refinement of a
    point mass (``np.linspace`` emitting duplicate / zero-width edges) is
    deduped: when an overfull bucket can no longer be narrowed the loop
    stops and the caller's oversized-bucket warning path takes over.
    """
    if not (np.isfinite(lo) and np.isfinite(hi)) or hi <= lo:
        # constant (or empty/degenerate) attribute: a single bucket
        edges = np.asarray([lo, np.nextafter(max(lo, hi), np.inf)])
        counts = np.asarray([src.num_rows], np.int64)
        return edges, counts
    edges = np.asarray([lo, np.nextafter(hi, np.inf)])
    counts = None
    for _ in range(max_depth):
        counts = _count_buckets(src, attr, edges, chunk_rows)
        if counts.max() <= r:
            return edges, counts
        new_edges = [edges[0]]
        for i, n in enumerate(counts):
            if n > r:
                splits = int(np.ceil(n / r))
                new_edges.extend(np.linspace(edges[i], edges[i + 1],
                                             splits + 1)[1:].tolist())
            else:
                new_edges.append(edges[i + 1])
        refined = np.unique(np.asarray(new_edges))   # dedupe zero-width
        if len(refined) == len(edges):
            break        # point mass: no new edge survived -- stop refining
        edges = refined
        counts = None
    if counts is None:
        counts = _count_buckets(src, attr, edges, chunk_rows)
    return edges, counts


# -------------------------------------------------------------- spill pass


class BucketSpill:
    """Bucket-major scratch for the single spill pass.

    Values land in one (n, k) scratch matrix laid out bucket-by-bucket
    (bucket b owns ``[off[b], off[b+1])``) with the matching (n,) global
    row ids; both become ``.npy`` memmaps in a private temp dir when the
    relation exceeds ``budget_rows``, removed again by :meth:`close`.
    """

    def __init__(self, counts: np.ndarray, k: int, budget_rows: int,
                 spill_dir: Optional[str] = None):
        self.off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        n = int(self.off[-1])
        self._cursor = self.off[:-1].copy()
        self._tmp = None
        if n > budget_rows:
            self._tmp = tempfile.mkdtemp(prefix="pq_spill_", dir=spill_dir)
            self.vals = np.lib.format.open_memmap(
                os.path.join(self._tmp, "vals.npy"), mode="w+",
                dtype=np.float64, shape=(n, k))
            self.rows = np.lib.format.open_memmap(
                os.path.join(self._tmp, "rows.npy"), mode="w+",
                dtype=np.int64, shape=(n,))
        else:
            self.vals = np.empty((n, k), np.float64)
            self.rows = np.empty(n, np.int64)

    @property
    def spilled(self) -> bool:
        return self._tmp is not None

    def add(self, chunk: np.ndarray, bidx: np.ndarray,
            row_base: int) -> None:
        """Append this chunk's rows to their buckets (contiguous writes)."""
        order = np.argsort(bidx, kind="stable")
        ccnt = np.bincount(bidx, minlength=len(self._cursor))
        present = np.flatnonzero(ccnt)
        starts = np.concatenate([[0], np.cumsum(ccnt[present])])
        for t, b in enumerate(present):
            sel = order[starts[t]:starts[t + 1]]
            c0 = self._cursor[b]
            c1 = c0 + len(sel)
            self.vals[c0:c1] = chunk[sel]
            self.rows[c0:c1] = row_base + sel
            self._cursor[b] = c1

    def bucket(self, b: int) -> Tuple[np.ndarray, np.ndarray]:
        """Bucket b's (values, global row ids) -- one resident copy."""
        s, e = self.off[b], self.off[b + 1]
        return np.array(self.vals[s:e]), np.array(self.rows[s:e])

    def close(self) -> None:
        self.vals = self.rows = None
        if self._tmp is not None:
            shutil.rmtree(self._tmp, ignore_errors=True)
            self._tmp = None


def _spill_pass(spill: BucketSpill, src: ChunkSource, attr: int,
                edges: np.ndarray, chunk_rows: int) -> None:
    """The ONE spill pass: every row to its bucket's scratch slice."""
    row_base = 0
    for c in src.chunks(chunk_rows):
        if not len(c):
            continue
        spill.add(np.asarray(c, np.float64), _bucket_ids(c[:, attr], edges),
                  row_base)
        row_base += len(c)
    if row_base != int(spill.off[-1]):
        raise RuntimeError(f"spill pass saw {row_base} rows but bucket "
                           f"counts sum to {int(spill.off[-1])} -- source "
                           "changed between passes?")


# ------------------------------------------------------------- merged tree


def _merge_bucket_trees(attr: int, edges: np.ndarray,
                        parts: List[Optional[Partition]],
                        group_offset: np.ndarray,
                        num_groups: int) -> SplitTree:
    """One unified flat tree: a root node on the bucket attribute whose
    children are the per-bucket subtrees (node ids and leaf gids offset
    into the global spaces)."""
    nb = len(parts)
    attrs = [np.asarray([attr], np.int32)]
    bound_off_len = [np.asarray([len(edges) - 2], np.int64)]
    bounds = [np.asarray(edges[1:-1], np.float64)]
    root_children = np.empty(nb, np.int64)
    sub_attrs, sub_lens, sub_bounds, sub_children = [], [], [], []
    node_base = 1
    for b, part in enumerate(parts):
        goff = int(group_offset[b])
        if part is None:
            # empty bucket: probes fall through to the next group base
            root_children[b] = ~min(goff, num_groups - 1)
            continue
        t = part.tree
        if t.num_nodes == 0:
            root_children[b] = ~goff
            continue
        root_children[b] = node_base + t.root
        sub_attrs.append(t.attr)
        sub_lens.append(np.diff(t.bound_off))
        sub_bounds.append(t.bounds)
        ch = t.children.copy()
        leaf = ch < 0
        ch[leaf] = ~(~ch[leaf] + goff)
        ch[~leaf] += node_base
        sub_children.append(ch)
        node_base += t.num_nodes
    attrs = np.concatenate(attrs + sub_attrs).astype(np.int32)
    lens = np.concatenate(bound_off_len + sub_lens)
    bound_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    all_bounds = np.concatenate(bounds + sub_bounds)
    children = np.concatenate([root_children] + sub_children) \
        if sub_children else root_children
    return SplitTree(attrs, bound_off, all_bounds,
                     children.astype(np.int64), 0)


def _merge_buckets(attr: int, edges: np.ndarray,
                   parts: List[Optional[Partition]], orders: list,
                   group_offset: np.ndarray, gid: np.ndarray, k: int,
                   num_groups: int) -> Partition:
    """The global contiguous layout (buckets in edge order, groups within
    a bucket) and the merged split tree."""
    built = [p for p in parts if p is not None]
    order = np.concatenate(orders) if orders else np.zeros(0, np.int64)
    off = [0]
    for part in built:
        off.extend((np.asarray(part.offsets[1:]) + off[-1]).tolist())
    offsets = np.asarray(off, np.int64)

    def stack(field):
        return np.concatenate([getattr(p, field) for p in built]) \
            if built else np.zeros((0, k))

    tree = _merge_bucket_trees(attr, edges, parts, group_offset,
                               max(num_groups, 1))
    return Partition(gid, order, offsets, stack("reps"), stack("boxes_lo"),
                     stack("boxes_hi"), tree)


# ------------------------------------------------------------- main build


_SPILL_MEM_ROWS = 1 << 22    # in-RAM scratch ceiling when spill_rows unset


def dlv_bucketed(src: ChunkSource, d_f: int, *, memory_rows: int,
                 chunk_rows: Optional[int] = None,
                 rng: Optional[np.random.Generator] = None,
                 method: str = "rounds", mesh=None,
                 spill_rows: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 device="cuda") -> Partition:
    """Appendix D.2: bucket on the max-variance attribute, DLV per bucket.

    The relation is read in O(1) full streaming passes regardless of the
    bucket count: one stats pass, <= max_depth counting passes for the
    edges, and ONE spill pass that lands every row in its bucket's scratch
    slice (see :class:`BucketSpill`); per-bucket DLV then consumes each
    contiguous slice on ``device``, all buckets drawing from the one
    ``rng`` in bucket order.  ``spill_rows`` bounds the in-RAM scratch
    (above it the scratch is memmap-backed; default ``max(memory_rows,
    4M)`` rows).
    """
    from repro_torch.core import relation as relation_mod  # late: a cycle

    no_mesh("dlv_bucketed", mesh)
    dev = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    chunk_rows = chunk_rows or max(memory_rows // 4, 1024)
    stats = streaming_stats(src, chunk_rows)
    attr = int(np.argmax(stats.var))
    edges, counts = _bucket_edges(src, attr, stats.lo[attr], stats.hi[attr],
                                  memory_rows, chunk_rows)
    nb = len(edges) - 1
    n = src.num_rows
    k = src.num_cols
    if spill_rows is None:
        spill_rows = max(memory_rows, _SPILL_MEM_ROWS)

    spill = BucketSpill(counts, k, spill_rows, spill_dir)
    try:
        _spill_pass(spill, src, attr, edges, chunk_rows)
        parts: List[Optional[Partition]] = []
        group_offset = np.zeros(nb, np.int64)
        gid = np.full(n, -1, np.int64)
        orders = []
        next_gid = 0
        for b in range(nb):
            group_offset[b] = next_gid
            if counts[b] == 0:
                parts.append(None)
                continue
            Xb, rows = spill.bucket(b)
            relation_mod.note_resident(len(Xb))
            # equal-width refinement can fail to isolate point masses /
            # duplicate-heavy clusters within max_depth; the budget is then
            # soft -- degrade to a larger in-memory bucket instead of dying
            if len(Xb) > max(memory_rows, 1):
                warnings.warn(f"bucket {b} holds {len(Xb)} rows "
                              f"(> memory_rows={memory_rows}); edge "
                              "refinement could not isolate a "
                              "concentration -- running in-memory DLV on "
                              "the oversized bucket")
            res = dlv(Xb, d_f, rng=rng, method=method, device=dev)
            parts.append(res)
            gid[rows] = next_gid + res.gid
            orders.append(rows[res.order])
            next_gid += res.num_groups
            del Xb, rows
    finally:
        spill.close()
    return _merge_buckets(attr, edges, parts, orders, group_offset, gid, k,
                          next_gid)


@register_backend("bucketing")
def _bucketing_backend(X, *, d_f: int = 100, memory_rows: int = None,
                       chunk_rows: Optional[int] = None,
                       rng: Optional[np.random.Generator] = None,
                       method: str = "rounds", mesh=None,
                       spill_rows: Optional[int] = None,
                       spill_dir: Optional[str] = None,
                       device="cuda") -> Partition:
    """Partitioner backend: accepts an array (wrapped in ArraySource) or
    any ChunkSource; each bucket's DLV runs on ``device``."""
    no_mesh("fit(backend='bucketing')", mesh)
    src = X if isinstance(X, ChunkSource) else ArraySource(np.asarray(X))
    if memory_rows is None:
        memory_rows = max(src.num_rows // 8, 4096)
    return dlv_bucketed(src, d_f, memory_rows=memory_rows,
                        chunk_rows=chunk_rows, rng=rng, method=method,
                        spill_rows=spill_rows, spill_dir=spill_dir,
                        device=device)


# Back-compat: the merged result is a plain Partition now.
BucketedDLV = Partition
