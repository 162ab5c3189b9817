"""Unified Partitioner subsystem (port of ``repro.core.partitioner``).

Every backend produces the same :class:`Partition`: group ids, a
permutation making groups contiguous slices, per-group representatives /
bounding boxes, and a flat array split tree answering GetGroup for one
tuple (scalar descent) or a whole batch (vectorized descent).  The tree
and the host descents are numpy, as in the reference; the batch descent
also runs on a device (``get_group_batch(T, jit=True, device=...)``: the
kernel ``kernels/split_tree.py`` on CUDA, its plain torch version on the
CPU), the counterpart of the reference's jitted descent.

Select a backend by name::

    from repro_torch.core import partitioner
    part = partitioner.fit(X, backend="dlv", d_f=100, device="cuda")
    part.get_group_batch(X[:1000])             # host numpy
    part.get_group_batch(X[:1000], jit=True)   # the descent on the card

The port registers the reference's three backends: ``dlv`` (the
batched-frontier build, on the device), ``kdtree`` (the SketchRefine
baseline, host numpy as in the reference) and ``bucketing`` (the
out-of-core Appendix D.2 scheme: host streaming passes, each bucket's DLV
on the device).  :func:`group_stats` is the reference's host pass: one
``reduceat`` sweep in memory, or a chunked accumulation with
``chunk_rows``; with a ``mesh`` as well, each chunk's sums run sharded
over the mesh's leading dim through the segment-stats kernel and a SUM
over that dim's group.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.distributed import row_shards
from repro_torch.device import resolve_device
from repro_torch.kernels import split_tree as split_tree_kernel
from repro_torch.kernels.segstats import MAX_K, segment_stats

# guards every SplitTree's cache of device copies: sessions share trees
# across threads
_DEVICE_COPIES_LOCK = threading.Lock()


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
    # device -> kernels.split_tree.PackedTree (the arrays and the packed
    # layout), made once
    _on_device: dict = dataclasses.field(default_factory=dict, init=False,
                                         repr=False, compare=False)

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

    def device_arrays(self, device) -> tuple:
        """(attr, bound_off, bounds, children) as tensors on ``device``,
        uploaded on the first call for that device and kept on the tree,
        with the descent kernel's packed layout of them
        (:meth:`device_packed`).  Raises ``ValueError`` on a node whose
        bounds hold a NaN or descend."""
        return self.device_packed(device).arrays

    def device_packed(self, device) -> "split_tree_kernel.PackedTree":
        """The tree on ``device`` as ``kernels.split_tree.pack_tree`` lays
        it out for the descent kernel (its arrays too), built once per
        tree and device."""
        dev = resolve_device(device)
        with _DEVICE_COPIES_LOCK:
            packed = self._on_device.get(dev)
            if packed is None:
                packed = self._on_device[dev] = split_tree_kernel.pack_tree(
                    self.attr, self.bound_off, self.bounds, self.children,
                    int(self.root), dev)
            return packed

    def descend_batch_device(self, T, device="cuda") -> torch.Tensor:
        """Batch GetGroup on ``device``: the counterpart of the reference's
        jitted ``descend_batch_jax``.  ``T`` (m, k) is an array or a tensor;
        returns an (m,) int64 tensor on ``device``, equal to
        :meth:`descend_batch`'s leaves.  On CUDA it is one launch of
        ``csrc/split_tree.cu``."""
        dev = resolve_device(device)
        T = torch.as_tensor(T, dtype=torch.float64, device=dev).contiguous()
        return split_tree_kernel.descend_batch(T, self.device_packed(dev))


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

    def get_group_batch(self, T: np.ndarray, *, jit: bool = False,
                        device="cuda") -> np.ndarray:
        """Group ids of the rows of ``T``: the host descent, or with
        ``jit=True`` the descent on ``device`` (numpy int64 either way;
        the reference's jitted form returns a ``jax.Array``)."""
        if jit:
            return self.tree.descend_batch_device(T, device).cpu().numpy()
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
    from repro_torch.core import bucketing, dlv, kdtree  # noqa: F401


def available_backends():
    _ensure_backends()
    return sorted(_BACKENDS)


def fit(X, *, backend: str = "dlv", **kwargs) -> Partition:
    """Partition ``X`` with the named backend: an (n, k) array, or a
    ChunkSource for ``bucketing`` (e.g. ``Relation.chunk_source()`` of an
    out-of-core table).  Backend keywords such as ``d_f``, ``rng`` and
    ``device`` pass through."""
    _ensure_backends()
    if backend not in _BACKENDS:
        raise ValueError(f"unknown partitioner backend {backend!r}; "
                         f"have {sorted(_BACKENDS)}")
    return _BACKENDS[backend](X, **kwargs)


# ------------------------------------------------------------- group stats


def group_stats(X: np.ndarray, order: np.ndarray, offsets: np.ndarray, *,
                mesh=None, chunk_rows: Optional[int] = None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(reps, boxes_lo, boxes_hi) for contiguous groups -- the one
    finalization pass shared by every backend (host numpy).

    In-memory default: a single vectorized ``reduceat`` sweep over
    ``X[order]``.  With ``chunk_rows`` set, the sorted relation is consumed
    chunk by chunk and only the (G, k) accumulators are kept whole; with
    ``mesh`` (a ``DeviceMesh``) also set, each chunk is padded to the same
    sharded shape (pad rows in the dead group G), each rank's rows go
    through ``kernels.segment_stats`` with G + 1 groups on its device, and
    the sums are added up over the mesh's leading dim (one SUM).
    """
    X = np.asarray(X)
    n, k = X.shape
    G = len(offsets) - 1
    counts = np.diff(offsets).astype(np.float64)
    if chunk_rows is None or n <= chunk_rows:
        Xo = X[order]
        sums = np.add.reduceat(Xo, offsets[:-1], axis=0) \
            if G else np.zeros((0, k))
        lo = np.minimum.reduceat(Xo, offsets[:-1], axis=0) \
            if G else np.zeros((0, k))
        hi = np.maximum.reduceat(Xo, offsets[:-1], axis=0) \
            if G else np.zeros((0, k))
        reps = sums / np.maximum(counts, 1.0)[:, None]
        return reps, lo, hi

    sums = np.zeros((G, k))
    lo = np.full((G, k), np.inf)
    hi = np.full((G, k), -np.inf)
    shards = None if mesh is None else row_shards(mesh)
    for a in range(0, n, chunk_rows):
        b = min(a + chunk_rows, n)
        chunk = X[order[a:b]]
        # contiguous layout -> chunk-local ids are sorted ascending
        ids = np.searchsorted(offsets, np.arange(a, b), side="right") - 1
        u0, u1 = int(ids[0]), int(ids[-1])
        if shards is not None:
            sums += _sharded_sums(shards, chunk, ids, G, chunk_rows)
        else:
            loc = ids - u0
            nloc = u1 - u0 + 1
            for j in range(k):
                sums[u0:u1 + 1, j] += np.bincount(loc, weights=chunk[:, j],
                                                  minlength=nloc)
        # boxes: reduceat over the chunk's group boundary positions
        bpos = np.concatenate([[0], np.flatnonzero(np.diff(ids)) + 1])
        np.minimum.at(lo, ids[bpos],
                      np.minimum.reduceat(chunk, bpos, axis=0))
        np.maximum.at(hi, ids[bpos],
                      np.maximum.reduceat(chunk, bpos, axis=0))
    reps = sums / np.maximum(counts, 1.0)[:, None]
    return reps, lo, hi


def _sharded_sums(shards, chunk: np.ndarray, ids: np.ndarray, G: int,
                  chunk_rows: int) -> np.ndarray:
    """(G, k) sums of one chunk over the mesh: the chunk padded to the
    same sharded shape for every chunk (pad rows zero, in group G), this
    rank's rows through the segment-stats kernel (at most ``MAX_K``
    columns a call), the partial sums added up over the shards' group."""
    per = -(-chunk_rows // shards.nd)
    dev = shards.device
    v = torch.as_tensor(shards.take(chunk, per, 0.0), device=dev)
    i = torch.as_tensor(shards.take(ids, per, G), dtype=torch.int64,
                        device=dev)
    s = torch.cat([segment_stats(v[:, j:j + MAX_K].contiguous(), i, G + 1)[1]
                   for j in range(0, v.shape[1], MAX_K)], dim=1)
    dist.all_reduce(s, group=shards.group)
    return s[:G].cpu().numpy()


def finalize(X: np.ndarray, order: np.ndarray, offsets: np.ndarray,
             tree: SplitTree, *, mesh=None,
             chunk_rows: Optional[int] = None) -> Partition:
    """Assemble a Partition from the contiguous layout + split tree."""
    n = len(order)
    G = len(offsets) - 1
    gid = np.empty(n, np.int64)
    gid[order] = np.repeat(np.arange(G), np.diff(offsets))
    reps, lo, hi = group_stats(X, order, offsets, mesh=mesh,
                               chunk_rows=chunk_rows)
    return Partition(gid, order, offsets, reps, lo, hi, tree)
