"""Neighbor Sampling — paper §2.2, Algorithm 3.

Expands the LP support S'_l (layer-l tuples) into layer-(l-1) candidates,
then augments with *neighboring groups* found by constructing 3^k probe
tuples just outside / inside each group's attribute box and locating their
groups via the split tree (GetGroup), until the candidate set reaches the
augmenting size alpha.  This is what recovers the paper's "hidden outliers".

All 3^k probes of a group descend the split tree in ONE vectorized batch
(``Partition.get_group_batch``); the discovered groups are then admitted
sequentially so the stop-at-alpha semantics match the scalar loop exactly.
"""
from __future__ import annotations

import heapq
import itertools
from typing import List, Set

import numpy as np

from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.relation import gather_column

MAX_PROBE_ATTRS = 8  # 3^8 = 6561 probes; queries use <= ~5 attrs


def neighbor_sampling(hier: Hierarchy, l: int, alpha: int,
                      s_prime: np.ndarray, obj_attr: str,
                      maximize: bool) -> np.ndarray:
    """Returns candidate indices at layer l-1 (at most alpha)."""
    layer = hier.layers[l]
    part = layer.part
    eps = layer.eps
    obj_l = layer.table[obj_attr]
    sgn = -1.0 if maximize else 1.0      # heap pops best objective first

    s_prime = np.asarray(s_prime, np.int64)
    members: List[np.ndarray] = [part.members_batch(s_prime)] \
        if len(s_prime) else []
    seen: Set[int] = set(int(g) for g in s_prime)
    count = sum(len(m) for m in members)
    heap: List = [(sgn * float(obj_l[g]), int(g)) for g in seen]
    heapq.heapify(heap)

    k = min(layer.X.shape[1], MAX_PROBE_ATTRS)
    corners = np.array(list(itertools.product(range(3), repeat=k)))  # (3^k, k)
    while heap and count < alpha:
        _, g = heapq.heappop(heap)
        lo, hi = hier.group_box(l, g)
        mid = 0.5 * (lo + hi)
        probes = np.tile(mid, (len(corners), 1))          # (3^k, k_full)
        choices = np.stack([lo[:k] - eps, mid[:k], hi[:k] + eps])  # (3, k)
        probes[:, :k] = choices[corners, np.arange(k)]
        gps = part.get_group_batch(probes)                # ONE batched descent
        for gp in gps:
            gp = int(gp)
            if gp not in seen:
                seen.add(gp)
                heapq.heappush(heap, (sgn * float(obj_l[gp]), gp))
                m = hier.get_tuples(l - 1, gp)
                members.append(m)
                count += len(m)
                if count >= alpha:
                    break

    cand = np.unique(np.concatenate(members)) if members else \
        np.zeros(0, np.int64)
    if len(cand) > alpha:
        # layer l-1 may be the streamed layer-0 relation: gather only the
        # candidate rows of the objective column
        obj_lm1 = gather_column(hier.layers[l - 1].table, obj_attr, cand)
        order = np.argsort(-obj_lm1 if maximize else obj_lm1, kind="stable")
        cand = np.sort(cand[order[:alpha]])
    return cand
