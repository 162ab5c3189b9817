"""Collective traffic of the port's hot paths (counterpart of
``repro.distributed.hlo_analysis``'s byte model).

The reference parses post-SPMD HLO text: it splits the computations,
recovers each while loop's trip count from its condition and weights the
collectives in a loop body by it.  The port lowers to no HLO: its
collectives are ``torch.distributed`` calls that the traced contracts
(:class:`repro_torch.analysis.contracts.OpTrace`) record as they run, one
record a call with its kind, its output bytes and its group size.  The
trip count is what the trace counts itself: the pivots between the
loop's trace points.  So this module keeps only the per-device ring model
and the pq step's declared budget:

  all-gather:          out_bytes * (n-1)/n
  reduce-scatter:      out_bytes * (n-1)
  all-reduce:          out_bytes * 2(n-1)/n
  all-to-all:          out_bytes * (n-1)/n
  collective-permute:  out_bytes
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

# headroom over the analytic byte model (the reference's): an accidental
# O(n) collective is orders of magnitude over budget, not a constant factor
BUDGET_HEADROOM = 4.0

FACTORS = {
    "all-gather": lambda n: (n - 1) / n,
    "reduce-scatter": lambda n: float(n - 1),
    "all-reduce": lambda n: 2 * (n - 1) / n,
    "all-to-all": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
}

# c10d ops as the dispatcher names them (``c10d.<op>.default``) -> kind
C10D_KINDS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "broadcast_": "collective-permute",
}


def pq_collective_budget(p: int, m: int, num_buckets: int = 128,
                         gather_k: int = 128, dtype_bytes: int = 8) -> float:
    """Declared per-pivot collective-byte budget of the pq step (the
    reference's ``analysis.contracts.pq_collective_budget``).

    The step's design-point traffic, O(num_buckets + p·K + m): the BFRT
    histogram all-reduce, the (p, K) exact-walk candidate all-gather (3
    float + 2 bool + 1 int64 per candidate, plus the per-shard trunc/kth
    scalars), the fvec/Acol sums and a fixed scalar overhead -- times
    :data:`BUDGET_HEADROOM`.  Anything O(n) blows this budget by
    construction.
    """
    hist = 2 * num_buckets * dtype_bytes               # all-reduce
    gathered = p * gather_k * (3 * dtype_bytes + 2 + 8)
    shard_scalars = p * (1 + dtype_bytes)              # trunc + kth
    vecs = 2 * 2 * m * dtype_bytes                     # fvec + Acol sums
    misc = 64 * dtype_bytes                            # rmin/rmax/n_flips/...
    return BUDGET_HEADROOM * (hist + gathered + shard_scalars + vecs + misc)


def link_bytes(kind: str, out_bytes: float, group: int) -> float:
    """Per-device link bytes of one collective of ``kind`` whose output
    is ``out_bytes`` over a group of ``group`` ranks (ring algorithms)."""
    return out_bytes * FACTORS[kind](max(int(group), 1))


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One traced collective: its kind (a key of :data:`FACTORS`), the
    bytes of its output, its group size, and the pivot it ran in."""
    kind: str
    out_bytes: int
    group: int
    pivot: int = 0

    @property
    def link_bytes(self) -> float:
        return link_bytes(self.kind, self.out_bytes, self.group)


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float]
    count_by_kind: Dict[str, int]
    total_bytes: float

    def merged(self) -> Dict[str, float]:
        out = dict(self.bytes_by_kind)
        out["total"] = self.total_bytes
        return out


def collective_stats(records: Iterable[CollectiveRecord],
                     per: Optional[int] = None) -> CollectiveStats:
    """Link bytes and counts by kind over ``records``; divided by ``per``
    (a pivot count) where given, as the reference weights a while body by
    its trip count the other way round."""
    by: Dict[str, float] = {}
    cnt: Dict[str, int] = {}
    for r in records:
        by[r.kind] = by.get(r.kind, 0.0) + r.link_bytes
        cnt[r.kind] = cnt.get(r.kind, 0) + 1
    if per:
        by = {k: v / per for k, v in by.items()}
    return CollectiveStats(by, cnt, sum(by.values()))
