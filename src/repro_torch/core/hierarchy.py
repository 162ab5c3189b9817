"""Hierarchy of relations (paper §2, Fig. 3) — port of
``repro.core.hierarchy``.

Layer 0 = original tuples; layer l >= 1 = representative tuples (group
means) from partitioning layer l-1 with downscale factor d_f, built until
the top layer has at most ``alpha`` tuples.  ``layers[l].part`` (l >= 1)
is the :class:`~repro_torch.core.partitioner.Partition` that partitioned
layer l-1.  The build runs the partitioner on ``device``; the layers
themselves (attribute matrices, partitions, split trees) are host numpy,
which is what the online solve reads.

The partitioning strategy is selected by name through the Partitioner
registry (``backend="dlv" | "kdtree" | "bucketing"``).

Out-of-core layer 0: the hierarchy accepts any
:class:`~repro_torch.core.relation.Relation` (or a dict of arrays).  A
streamed relation is partitioned through the ``bucketing`` backend -- the
default for out-of-core sources -- consuming the relation chunk by chunk
without ever materialising the layer-0 attribute matrix (``Layer.X`` is
None there); ``memory_rows`` bounds the per-bucket resident set, each
bucket's DLV runs on ``device`` and ``mesh`` (a ``DeviceMesh``) shards
the streaming stats and counting passes.  For in-memory tables
``chunk_rows`` (optionally with ``mesh``) routes layer-0 group stats
through the chunked (mesh-sharded) accumulation, and
``layer0_backend="bucketing"`` with the same ``memory_rows`` gives the
memmap build's partition bit for bit.

:meth:`Hierarchy.from_arrays` loads a hierarchy built elsewhere (for
example by the reference package) from plain arrays.

Appends (the Stochastic SketchRefine re-partitioning story): see
:meth:`Hierarchy.append` -- new tuples descend to their layer-0 leaf
through the split tree on the hierarchy's ``device`` (the descent kernel
on CUDA, its plain version on the CPU), leaf counts and moments grow on
the host, leaves whose total variance crosses the build-time bar are
reported for a local re-split (the re-split itself is later work), and
the invalidation hooks (``core.qcache``) hear which leaves were touched.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core import partitioner
from repro_torch.core.distributed import mesh_device
from repro_torch.core.partitioner import Partition, SplitTree
from repro_torch.core.relation import Relation, as_relation
from repro_torch.device import resolve_device

_EXACT_GAP_LIMIT = 2_000_000
_GAP_SAMPLE = 200_000


def _min_gap(X: np.ndarray, *, exact_limit: int = _EXACT_GAP_LIMIT,
             sample: int = _GAP_SAMPLE,
             rng: Optional[np.random.Generator] = None) -> float:
    """Smallest positive per-attribute gap (Alg 3, line 1): exact up to
    ``exact_limit`` rows, above that estimated on a sorted random sample
    (which can only overestimate it)."""
    n = X.shape[0]
    if n > exact_limit:
        rng = rng or np.random.default_rng(0)
        X = X[rng.choice(n, size=sample, replace=False)]
    best = np.inf
    for j in range(X.shape[1]):
        v = np.sort(X[:, j])
        gaps = np.diff(v)
        pos = gaps[gaps > 0]
        if len(pos):
            best = min(best, float(pos.min()))
    return best if np.isfinite(best) else 1e-9


@dataclasses.dataclass
class Layer:
    table: Union[Relation, Dict[str, np.ndarray]]
    X: Optional[np.ndarray]          # (n_l, k) attr matrix; None = streamed
    part: Optional[Partition]        # partition of layer l-1 (None for layer 0)
    eps: float                       # min positive attr gap (Alg 3, line 1)

    @property
    def size(self) -> int:
        if self.X is not None:
            return self.X.shape[0]
        return self.table.num_rows


@dataclasses.dataclass
class AppendReport:
    """Result of one :meth:`Hierarchy.append` call."""
    gids: np.ndarray          # layer-0 leaf (group) id per appended tuple
    flagged: np.ndarray       # leaves whose total variance crossed the bar
    tv_bar: float             # the bar the leaves were compared against


class Hierarchy:
    def __init__(self, table, attrs: Sequence[str],
                 d_f: int = 100, alpha: int = 100_000,
                 rng: Optional[np.random.Generator] = None,
                 max_layers: int = 12, backend: str = "dlv",
                 layer0_backend: Optional[str] = None,
                 backend_kwargs: Optional[dict] = None,
                 mesh=None, chunk_rows: Optional[int] = None,
                 memory_rows: Optional[int] = None, device="cuda"):
        if mesh is not None:
            mesh_device(mesh, device)
        self.attrs = list(attrs)
        self.d_f = d_f
        self.alpha = alpha
        self.backend = backend
        self.device = resolve_device(device)
        self._fingerprint: Optional[str] = None
        self._append_state: Optional[dict] = None
        self._invalidation_hooks: List[Callable] = []
        rng = rng or np.random.default_rng(0)
        rel = as_relation(table, columns=self.attrs)
        self.relation = rel
        if layer0_backend is None:
            # streamed relations default layer 0 to the one chunk-capable
            # backend; upper layers (rep arrays) keep ``backend``
            layer0_backend = "bucketing" \
                if (not rel.in_memory and backend == "dlv") else backend
        if not rel.in_memory and layer0_backend != "bucketing":
            raise TypeError(
                f"partitioner backend {layer0_backend!r} cannot consume a "
                "streamed relation (only 'bucketing' scans ChunkSources); "
                "pass an in-memory table or layer0_backend='bucketing'")
        self.layer0_backend = layer0_backend
        if rel.in_memory:
            X0 = np.stack([np.asarray(rel[a], np.float64)
                           for a in self.attrs], axis=1)
            self.layers: List[Layer] = [
                Layer(rel, X0, None, _min_gap(X0, rng=rng))]
        else:
            # layer-0 eps is never consumed (Neighbor Sampling probes only
            # layers >= 1), so a streamed build skips the sample gather
            self.layers = [Layer(rel, None, None, 1e-9)]
        kw = dict(backend_kwargs or {})
        while self.layers[-1].size > alpha and len(self.layers) <= max_layers:
            layer_kw = dict(kw, device=self.device)
            if len(self.layers) == 1 and not rel.in_memory:
                # streamed layer 0: the bucketing backend consumes the
                # relation chunk by chunk (Appendix D.2) -- the attribute
                # matrix never materialises
                if memory_rows is not None:
                    layer_kw.setdefault("memory_rows", memory_rows)
                if chunk_rows is not None:
                    layer_kw.setdefault("chunk_rows", chunk_rows)
                if mesh is not None:
                    layer_kw.setdefault("mesh", mesh)
                part = partitioner.fit(
                    rel.chunk_source(self.attrs, chunk_rows),
                    backend=layer0_backend, d_f=d_f, rng=rng, **layer_kw)
            else:
                lb = layer0_backend if len(self.layers) == 1 else backend
                if len(self.layers) == 1 and chunk_rows is not None:
                    # layer 0 is the big one: chunked (optionally mesh-
                    # sharded) group-stats accumulation instead of a full
                    # sorted copy
                    layer_kw.update(chunk_rows=chunk_rows, mesh=mesh)
                if len(self.layers) == 1 and lb == "bucketing" and \
                        memory_rows is not None:
                    # same bucket layout as the streamed path -> in-memory
                    # and memmap builds of the same data stay bit-identical
                    layer_kw.setdefault("memory_rows", memory_rows)
                part = partitioner.fit(self.layers[-1].X, backend=lb,
                                       d_f=d_f, rng=rng, **layer_kw)
            if part.num_groups >= self.layers[-1].size:
                break  # no reduction possible
            reps = part.reps
            tbl = {a: reps[:, i] for i, a in enumerate(self.attrs)}
            self.layers.append(Layer(tbl, reps, part, _min_gap(reps)))

    @classmethod
    def from_arrays(cls, table, attrs: Sequence[str], layers: Sequence[dict],
                    *, d_f: int, alpha: int, device="cuda",
                    eps0: float = 1e-9) -> "Hierarchy":
        """A hierarchy from plain arrays, one dict per layer l >= 1 with
        the partition of layer l-1: ``gid``, ``order``, ``offsets``,
        ``reps``, ``lo``, ``hi`` (boxes), the split tree's ``attr``,
        ``bound_off``, ``bounds``, ``children``, ``root``, and ``eps``.
        ``eps0`` is layer 0's gap (never read by the solve)."""
        self = cls.__new__(cls)
        self.attrs = list(attrs)
        self.d_f, self.alpha = d_f, alpha
        self.backend = self.layer0_backend = "dlv"
        self.device = resolve_device(device)
        self._fingerprint = None
        self._append_state = None
        self._invalidation_hooks = []
        rel = as_relation(table, columns=self.attrs)
        self.relation = rel
        X0 = np.stack([np.asarray(rel[a], np.float64) for a in self.attrs],
                      axis=1)
        self.layers = [Layer(rel, X0, None, float(eps0))]
        for ly in layers:
            tree = SplitTree(np.asarray(ly["attr"], np.int32),
                             np.asarray(ly["bound_off"], np.int64),
                             np.asarray(ly["bounds"], np.float64),
                             np.asarray(ly["children"], np.int64),
                             int(ly["root"]))
            part = Partition(np.asarray(ly["gid"], np.int64),
                             np.asarray(ly["order"], np.int64),
                             np.asarray(ly["offsets"], np.int64),
                             np.asarray(ly["reps"], np.float64),
                             np.asarray(ly["lo"], np.float64),
                             np.asarray(ly["hi"], np.float64), tree)
            reps = part.reps
            tbl = {a: reps[:, i] for i, a in enumerate(self.attrs)}
            self.layers.append(Layer(tbl, reps, part, float(ly["eps"])))
        return self

    @property
    def L(self) -> int:
        return len(self.layers) - 1

    @property
    def fingerprint(self) -> str:
        """Stable identity of this hierarchy's structure: the build
        parameters, layer shapes and per-layer group-count vectors."""
        if self._fingerprint is None:
            h = hashlib.sha1()
            h.update(repr((self.relation.num_rows, tuple(self.attrs),
                           self.d_f, self.alpha, self.backend,
                           self.layer0_backend,
                           tuple(l.size for l in self.layers))).encode())
            for lyr in self.layers[1:]:
                h.update(np.ascontiguousarray(
                    lyr.part.counts, dtype=np.int64).tobytes())
            self._fingerprint = h.hexdigest()
        return self._fingerprint

    # ----------------------------------------------------- invalidation
    def add_invalidation_hook(self, cb: Callable) -> None:
        """Register ``cb(hier, touched_leaf_gids)`` to fire on every
        :meth:`append` with the layer-0 leaves the new rows landed in
        (``core.qcache`` subscribes here)."""
        if cb not in self._invalidation_hooks:
            self._invalidation_hooks.append(cb)

    def leaf_ancestors(self, leaves) -> Dict[int, np.ndarray]:
        """Map layer -> group ids on the ancestor paths of the given
        layer-0 leaves: ``{1: leaves, 2: their layer-2 groups, ...}`` --
        the cached per-group artifacts an append to those leaves
        invalidates."""
        ids = np.unique(np.asarray(leaves, np.int64))
        out: Dict[int, np.ndarray] = {1: ids}
        for l in range(2, self.L + 1):
            ids = np.unique(np.asarray(self.layers[l].part.gid[ids],
                                       np.int64))
            out[l] = ids
        return out

    def get_tuples(self, l_minus_1: int, g: int) -> np.ndarray:
        """Member indices (at layer l-1) of group g (a layer-l tuple)."""
        return self.layers[l_minus_1 + 1].part.members(g)

    def get_tuples_batch(self, l_minus_1: int, gs: np.ndarray) -> np.ndarray:
        """Concatenated member indices of many groups (one gather)."""
        return self.layers[l_minus_1 + 1].part.members_batch(gs)

    def get_group(self, l: int, t: np.ndarray) -> int:
        return self.layers[l].part.get_group(t)

    def get_group_batch(self, l: int, T: np.ndarray, **kw) -> np.ndarray:
        """Vectorized split-tree descent for a whole batch of tuples
        (``jit=True``: on the hierarchy's device unless ``device=``)."""
        if kw.get("jit"):
            kw.setdefault("device", self.device)
        return self.layers[l].part.get_group_batch(T, **kw)

    def group_box(self, l: int, g: int):
        part = self.layers[l].part
        return part.boxes_lo[g], part.boxes_hi[g]

    # --------------------------------------------------------- appends
    def _init_append_state(self) -> dict:
        """Per-leaf (count, sum, sumsq) of the layer-0 partition, computed
        once with the reference's chunked host bincount pass over the
        relation (the same additions, so ``tv_bar`` and the flagged leaves
        are the reference's bit for bit); the total-variance bar is the
        worst build-time leaf."""
        part = self.layers[1].part
        G = part.num_groups
        k = len(self.attrs)
        cnt = part.counts.astype(np.float64).copy()
        s1 = np.zeros((G, k))
        s2 = np.zeros((G, k))
        a = 0
        for block in self.relation.chunks(tuple(self.attrs)):
            ids = part.gid[a:a + len(block)]
            for j in range(k):
                s1[:, j] += np.bincount(ids, weights=block[:, j],
                                        minlength=G)
                s2[:, j] += np.bincount(ids, weights=block[:, j] ** 2,
                                        minlength=G)
            a += len(block)
        nz = np.maximum(cnt, 1.0)[:, None]
        var = np.maximum(s2 / nz - (s1 / nz) ** 2, 0.0)
        tv = cnt * var.max(axis=1)
        return {"cnt": cnt, "s1": s1, "s2": s2,
                "tv_bar": float(tv.max()) if G else 0.0}

    def append(self, rows, *, tv_bar: Optional[float] = None
               ) -> AppendReport:
        """Fast-path append toward Stochastic SketchRefine re-partitioning.

        ``rows`` (a dict of columns or an (r, k) array in ``attrs`` order)
        descend the layer-0 split tree in ONE batch descent on the
        hierarchy's device; each leaf's count / per-attribute moments grow
        incrementally, and the report lists every leaf whose total
        variance (|P| * max_j var_j) now exceeds ``tv_bar`` (default: the
        worst leaf at build time).  The base relation and split tree are
        NOT rewritten here; the invalidation hooks fire with the touched
        leaves.
        """
        if self.L < 1:
            raise ValueError("hierarchy has no partition layer to append "
                             "into")
        if isinstance(rows, dict):
            R = np.stack([np.asarray(rows[a], np.float64)
                          for a in self.attrs], axis=1)
        else:
            R = np.atleast_2d(np.asarray(rows, np.float64))
        if R.shape[1] != len(self.attrs):
            raise ValueError(f"appended rows have {R.shape[1]} attrs, "
                             f"hierarchy has {len(self.attrs)}")
        if self._append_state is None:
            self._append_state = self._init_append_state()
        st = self._append_state
        gids = self.get_group_batch(1, R, jit=True)
        G = len(st["cnt"])
        st["cnt"] += np.bincount(gids, minlength=G)
        for j in range(R.shape[1]):
            st["s1"][:, j] += np.bincount(gids, weights=R[:, j],
                                          minlength=G)
            st["s2"][:, j] += np.bincount(gids, weights=R[:, j] ** 2,
                                          minlength=G)
        bar = st["tv_bar"] if tv_bar is None else float(tv_bar)
        nz = np.maximum(st["cnt"], 1.0)[:, None]
        var = np.maximum(st["s2"] / nz - (st["s1"] / nz) ** 2, 0.0)
        tv = st["cnt"] * var.max(axis=1)
        touched = np.unique(gids)
        for cb in self._invalidation_hooks:
            cb(self, touched)
        return AppendReport(gids, np.flatnonzero(tv > bar), bar)

    @property
    def leaf_counts(self) -> np.ndarray:
        """Layer-0 leaf sizes including appended tuples."""
        if self._append_state is not None:
            return self._append_state["cnt"].astype(np.int64)
        return self.layers[1].part.counts
