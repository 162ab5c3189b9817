"""Unified Partitioner subsystem (port of ``repro.core.partitioner``).

Every backend produces the same :class:`Partition`: group ids, a
permutation making groups contiguous slices, per-group representatives /
bounding boxes, and a flat array split tree answering GetGroup for one
tuple (scalar descent) or a whole batch (vectorized descent).  The tree
and the descents are host numpy, as in the reference.

Select a backend by name::

    from repro_torch.core import partitioner
    part = partitioner.fit(X, backend="dlv", d_f=100, device="cuda")
    part.get_group_batch(X[:1000])

The port registers ``dlv`` (the batched-frontier build on the device);
``kdtree`` and ``bucketing`` are later work.  :func:`group_stats` is the
in-memory ``reduceat`` pass of the reference (host numpy).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np


# ---------------------------------------------------------------- split tree


@dataclasses.dataclass
class SplitTree:
    """Flat array split tree (replaces the old ``List[SplitNode]`` pointers).

    Node ``i`` splits on attribute ``attr[i]`` with ascending boundary
    values ``bounds[bound_off[i]:bound_off[i+1]]``; its ``b_i + 1`` children
    (``b_i`` = number of bounds) live at ``children[bound_off[i] + i :]`` —
    the child base is ``bound_off[i] + i`` because every node has exactly
    one more child than bounds, so no second offset array is needed.
    ``children`` entries >= 0 are node ids; entries < 0 encode leaf group
    ids as ``~gid``.  ``root`` is a node id, or ``~gid`` when the partition
    never split (single group).
    """
    attr: np.ndarray          # (N,) int32
    bound_off: np.ndarray     # (N+1,) int64
    bounds: np.ndarray        # (B,) float64
    children: np.ndarray      # (B+N,) int64
    root: int

    @property
    def num_nodes(self) -> int:
        return len(self.attr)

    @staticmethod
    def single_leaf() -> "SplitTree":
        return SplitTree(np.zeros(0, np.int32), np.zeros(1, np.int64),
                         np.zeros(0, np.float64), np.zeros(0, np.int64), ~0)

    def descend(self, t: np.ndarray) -> int:
        """Scalar GetGroup: sub-linear split-tree descent (GiST analogue)."""
        node = int(self.root)
        while node >= 0:
            b0, b1 = self.bound_off[node], self.bound_off[node + 1]
            pos = b0 + np.searchsorted(self.bounds[b0:b1],
                                       t[self.attr[node]], side="right")
            node = int(self.children[node + pos])
        return ~node

    def descend_batch(self, T: np.ndarray) -> np.ndarray:
        """Vectorized GetGroup over a (m, k) batch of tuples.

        All rows descend in lock-step: one vectorized binary search per
        tree level over each row's private bounds slice (ragged slices, so
        a masked manual bisection instead of ``np.searchsorted``).
        """
        T = np.asarray(T, np.float64)
        cur = np.full(T.shape[0], self.root, np.int64)
        if self.num_nodes == 0:
            return ~cur
        act = np.flatnonzero(cur >= 0)
        while len(act):
            nodes = cur[act]
            vals = T[act, self.attr[nodes]]
            lo = self.bound_off[nodes].copy()
            hi = self.bound_off[nodes + 1].copy()
            live = lo < hi
            while live.any():
                mid = (lo + hi) >> 1
                take = live & (self.bounds[np.minimum(mid, len(self.bounds)
                                                      - 1)] <= vals)
                lo = np.where(take, mid + 1, lo)
                hi = np.where(live & ~take, mid, hi)
                live = lo < hi
            cur[act] = self.children[nodes + lo]   # child base = bound_off+node
            act = act[cur[act] >= 0]
        return ~cur


# ----------------------------------------------------------------- Partition


@dataclasses.dataclass
class Partition:
    """Common result of every partitioning backend (``fit``)."""
    gid: np.ndarray           # (n,) group id per tuple
    order: np.ndarray         # permutation; groups are contiguous slices
    offsets: np.ndarray       # (G+1,) slice bounds into order
    reps: np.ndarray          # (G, k) group means (representative tuples)
    boxes_lo: np.ndarray      # (G, k) member min per attr
    boxes_hi: np.ndarray      # (G, k)
    tree: SplitTree

    @property
    def num_groups(self) -> int:
        return len(self.offsets) - 1

    @property
    def counts(self) -> np.ndarray:
        return np.diff(self.offsets)

    def members(self, g: int) -> np.ndarray:
        return self.order[self.offsets[g]:self.offsets[g + 1]]

    def members_batch(self, gs: np.ndarray) -> np.ndarray:
        """Concatenated members of groups ``gs`` (one vectorized gather)."""
        gs = np.asarray(gs, np.int64)
        starts = self.offsets[gs]
        lens = self.offsets[gs + 1] - starts
        total = int(lens.sum())
        if total == 0:
            return np.zeros(0, np.int64)
        base = np.repeat(starts - np.concatenate(
            [[0], np.cumsum(lens)[:-1]]), lens)
        return self.order[base + np.arange(total)]

    def get_group(self, t: np.ndarray) -> int:
        return self.tree.descend(np.asarray(t))

    def get_group_batch(self, T: np.ndarray):
        return self.tree.descend_batch(T)


# --------------------------------------------------------- backend registry


_BACKENDS: Dict[str, Callable[..., Partition]] = {}


def register_backend(name: str):
    def deco(fn):
        _BACKENDS[name] = fn
        return fn
    return deco


def _ensure_backends() -> None:
    # Importing the strategy modules registers them (kept lazy so this
    # module stays import-cycle-free).
    from repro_torch.core import dlv  # noqa: F401


def available_backends():
    _ensure_backends()
    return sorted(_BACKENDS)


def fit(X, *, backend: str = "dlv", **kwargs) -> Partition:
    """Partition the (n, k) array ``X`` with the named backend (backend
    keywords such as ``d_f``, ``rng`` and ``device`` pass through)."""
    _ensure_backends()
    if backend not in _BACKENDS:
        raise ValueError(f"unknown partitioner backend {backend!r}; "
                         f"have {sorted(_BACKENDS)}")
    return _BACKENDS[backend](X, **kwargs)


# ------------------------------------------------------------- group stats


def group_stats(X: np.ndarray, order: np.ndarray, offsets: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(reps, boxes_lo, boxes_hi) for contiguous groups: one vectorized
    ``reduceat`` sweep over ``X[order]``."""
    X = np.asarray(X)
    n, k = X.shape
    G = len(offsets) - 1
    counts = np.diff(offsets).astype(np.float64)
    Xo = X[order]
    sums = np.add.reduceat(Xo, offsets[:-1], axis=0) \
        if G else np.zeros((0, k))
    lo = np.minimum.reduceat(Xo, offsets[:-1], axis=0) \
        if G else np.zeros((0, k))
    hi = np.maximum.reduceat(Xo, offsets[:-1], axis=0) \
        if G else np.zeros((0, k))
    reps = sums / np.maximum(counts, 1.0)[:, None]
    return reps, lo, hi


def finalize(X: np.ndarray, order: np.ndarray, offsets: np.ndarray,
             tree: SplitTree) -> Partition:
    """Assemble a Partition from the contiguous layout + split tree."""
    n = len(order)
    G = len(offsets) - 1
    gid = np.empty(n, np.int64)
    gid[order] = np.repeat(np.arange(G), np.diff(offsets))
    reps, lo, hi = group_stats(X, order, offsets)
    return Partition(gid, order, offsets, reps, lo, hi, tree)
