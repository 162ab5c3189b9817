"""Hierarchy of relations (paper §2, Fig. 3) — port of
``repro.core.hierarchy`` for in-memory tables.

Layer 0 = original tuples; layer l >= 1 = representative tuples (group
means) from partitioning layer l-1 with downscale factor d_f, built until
the top layer has at most ``alpha`` tuples.  ``layers[l].part`` (l >= 1)
is the :class:`~repro_torch.core.partitioner.Partition` that partitioned
layer l-1.  The build runs the partitioner on ``device``; the layers
themselves (attribute matrices, partitions, split trees) are host numpy,
which is what the online solve reads.

:meth:`Hierarchy.from_arrays` loads a hierarchy built elsewhere (for
example by the reference package) from plain arrays.  Appends and
streamed layer-0 relations are later work.
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
    X: np.ndarray                    # (n_l, k) attr matrix
    part: Optional[Partition]        # partition of layer l-1 (None for layer 0)
    eps: float                       # min positive attr gap (Alg 3, line 1)

    @property
    def size(self) -> int:
        return self.X.shape[0]


class Hierarchy:
    def __init__(self, table, attrs: Sequence[str],
                 d_f: int = 100, alpha: int = 100_000,
                 rng: Optional[np.random.Generator] = None,
                 max_layers: int = 12, backend: str = "dlv",
                 backend_kwargs: Optional[dict] = None, device="cuda"):
        self.attrs = list(attrs)
        self.d_f = d_f
        self.alpha = alpha
        self.backend = backend
        self.layer0_backend = backend
        self.device = resolve_device(device)
        self._fingerprint: Optional[str] = None
        rng = rng or np.random.default_rng(0)
        rel = as_relation(table, columns=self.attrs)
        if not rel.in_memory:
            raise TypeError("streamed relations are not ported yet; pass an "
                            "in-memory table")
        self.relation = rel
        X0 = np.stack([np.asarray(rel[a], np.float64) for a in self.attrs],
                      axis=1)
        self.layers: List[Layer] = [Layer(rel, X0, None,
                                          _min_gap(X0, rng=rng))]
        kw = dict(backend_kwargs or {})
        while self.layers[-1].size > alpha and len(self.layers) <= max_layers:
            part = partitioner.fit(self.layers[-1].X, backend=backend,
                                   d_f=d_f, rng=rng, device=self.device,
                                   **kw)
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

    def get_group_batch(self, l: int, T: np.ndarray) -> np.ndarray:
        """Vectorized split-tree descent for a whole batch of tuples."""
        return self.layers[l].part.get_group_batch(T)

    def group_box(self, l: int, g: int):
        part = self.layers[l].part
        return part.boxes_lo[g], part.boxes_hi[g]
