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
None there); ``memory_rows`` bounds the per-bucket resident set and each
bucket's DLV runs on ``device``.  For in-memory tables ``chunk_rows``
routes layer-0 group stats through the chunked accumulation, and
``layer0_backend="bucketing"`` with the same ``memory_rows`` gives the
memmap build's partition bit for bit.

:meth:`Hierarchy.from_arrays` loads a hierarchy built elsewhere (for
example by the reference package) from plain arrays.  Appends and the
mesh-sharded passes are later work.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core import partitioner
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


class Hierarchy:
    def __init__(self, table, attrs: Sequence[str],
                 d_f: int = 100, alpha: int = 100_000,
                 rng: Optional[np.random.Generator] = None,
                 max_layers: int = 12, backend: str = "dlv",
                 layer0_backend: Optional[str] = None,
                 backend_kwargs: Optional[dict] = None,
                 mesh=None, chunk_rows: Optional[int] = None,
                 memory_rows: Optional[int] = None, device="cuda"):
        partitioner.no_mesh("Hierarchy", mesh)
        self.attrs = list(attrs)
        self.d_f = d_f
        self.alpha = alpha
        self.backend = backend
        self.device = resolve_device(device)
        self._fingerprint: Optional[str] = None
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
                part = partitioner.fit(
                    rel.chunk_source(self.attrs, chunk_rows),
                    backend=layer0_backend, d_f=d_f, rng=rng, **layer_kw)
            else:
                lb = layer0_backend if len(self.layers) == 1 else backend
                if len(self.layers) == 1 and chunk_rows is not None:
                    # layer 0 is the big one: chunked group-stats
                    # accumulation instead of a full sorted copy
                    layer_kw["chunk_rows"] = chunk_rows
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

    def get_tuples(self, l_minus_1: int, g: int) -> np.ndarray:
        """Member indices (at layer l-1) of group g (a layer-l tuple)."""
        return self.layers[l_minus_1 + 1].part.members(g)

    def get_tuples_batch(self, l_minus_1: int, gs: np.ndarray) -> np.ndarray:
        """Concatenated member indices of many groups (one gather)."""
        return self.layers[l_minus_1 + 1].part.members_batch(gs)

    def get_group(self, l: int, t: np.ndarray) -> int:
        return self.layers[l].part.get_group(t)

    def get_group_batch(self, l: int, T: np.ndarray, **kw) -> np.ndarray:
        """Vectorized split-tree descent for a whole batch of tuples."""
        return self.layers[l].part.get_group_batch(T, **kw)

    def group_box(self, l: int, g: int):
        part = self.layers[l].part
        return part.boxes_lo[g], part.boxes_hi[g]
