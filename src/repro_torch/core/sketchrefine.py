"""SketchRefine baseline (Brucato et al. [5]) -- the prior state of the art
Progressive Shading is evaluated against (paper §4.2); port of
``repro.core.sketchrefine``.

Sketch: solve the package ILP over KD-tree representative tuples, where each
representative may be picked up to |group| times.  Refine: for each sketched
group in objective order, replace its representative with the group's actual
tuples and re-solve, keeping already-fixed tuples and the other groups'
representatives; greedy, no backtracking -- exactly the behaviour whose
false-infeasibility/quality limits §4.2 demonstrates.  The sketch and
refine ILPs are the host ``solve_ilp``, as in the reference; a DLV or
bucketed partition runs on ``device``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import ilp as ilp_mod
from repro_torch.core import partitioner
from repro_torch.core.dual_reducer import PackageResult
from repro_torch.core.paql import PackageQuery
from repro_torch.core.relation import as_relation
from repro_torch.device import resolve_device


def sketch_refine(query: PackageQuery, table, attrs, *,
                  tau_frac: float = 0.001,
                  ilp_kwargs: Optional[dict] = None,
                  backend: str = "kdtree",
                  memory_rows: Optional[int] = None,
                  chunk_rows: Optional[int] = None,
                  device="cuda") -> PackageResult:
    """SketchRefine over any registered partitioner backend (the paper's
    baseline uses KD-tree; ``backend="dlv"`` gives Stochastic-SketchRefine
    style cheap re-partitioning on DLV groups).  ``table`` may be a dict
    of arrays or a Relation: a streamed relation is partitioned through
    the out-of-core bucketing backend and the refine loop gathers only
    each step's fixed tuples + one group's members."""
    dev = resolve_device(device)
    ilp_kwargs = dict(ilp_kwargs or {})
    ilp_kwargs.setdefault("device", dev)      # wide B&B waves, if asked
    rel = as_relation(table, columns=list(attrs))
    n = rel.num_rows
    tau = max(2, int(tau_frac * n))
    if rel.in_memory:
        # repro: allow[REPRO005] guarded by rel.in_memory: resident view
        X = np.stack([np.asarray(rel[a], np.float64) for a in attrs],
                     axis=1)
        part = partitioner.fit(X, backend=backend, device=dev,
                               **({"tau": tau} if backend == "kdtree"
                                  else {"d_f": tau}))
    else:
        kw = {"d_f": tau}
        if memory_rows is not None:
            kw["memory_rows"] = memory_rows
        if chunk_rows is not None:
            kw["chunk_rows"] = chunk_rows
        part = partitioner.fit(rel.chunk_source(list(attrs), chunk_rows),
                               backend="bucketing", device=dev, **kw)
    col = {a: part.reps[:, i] for i, a in enumerate(attrs)}
    sizes = part.counts.astype(np.float64)

    # ---- sketch: ILP over representatives, multiplicity up to group size
    c, A, bl, bu, _ = query.matrices(col, None)
    res = ilp_mod.solve_ilp(c, A, bl, bu, sizes * (query.repeat + 1),
                            **ilp_kwargs)
    if not res.feasible:
        return PackageResult(False, np.zeros(0, np.int64), np.zeros(0),
                             0.0, 0.0, status="sketch_infeasible")
    lp_obj_query = -res.lp_obj if query.maximize else res.lp_obj

    # ---- refine: group by group, in representative-objective order
    chosen_groups = np.flatnonzero(res.x > 0.5)
    obj_rep = col[query.objective_attr][chosen_groups]
    order = np.argsort(-obj_rep if query.maximize else obj_rep)
    chosen_groups = chosen_groups[order]

    attrs_q = query_attrs(query, table)
    fixed_idx: list = []
    fixed_mult: list = []
    rep_mult = res.x.copy()
    for g in chosen_groups:
        members = np.flatnonzero(part.gid == g)
        # candidate variables: fixed tuples (bounds pinned) + this group's
        # tuples + remaining representatives
        rem_groups = rep_mult.copy()
        rem_groups[g] = 0.0
        rg = np.flatnonzero(rem_groups > 0.5)
        nf, ng, nr = len(fixed_idx), len(members), len(rg)
        fixed_view = rel.gather_rows(np.asarray(fixed_idx, np.int64),
                                     attrs_q) if nf else \
            {a: np.zeros(0) for a in attrs_q}
        mem_view = rel.gather_rows(members, attrs_q)
        cols = {a: np.concatenate([fixed_view[a], mem_view[a],
                                   col[a][rg]]) for a in attrs_q}
        c2, A2, bl2, bu2, _ = query.matrices(cols, None)
        lb2 = np.concatenate([np.asarray(fixed_mult, np.float64) if nf
                              else np.zeros(0), np.zeros(ng + nr)])
        ub2 = np.concatenate([
            np.asarray(fixed_mult, np.float64) if nf else np.zeros(0),
            np.full(ng, query.repeat + 1.0),
            sizes[rg] * (query.repeat + 1)])
        r2 = ilp_mod.solve_ilp(c2, A2, bl2, bu2, ub2, lb=lb2, **ilp_kwargs)
        if not r2.feasible:
            return PackageResult(False, np.zeros(0, np.int64), np.zeros(0),
                                 0.0, lp_obj_query,
                                 status="refine_infeasible")
        x2 = r2.x
        gm = x2[nf:nf + ng]
        nz = gm > 0.5
        fixed_idx.extend(members[nz].tolist())
        fixed_mult.extend(gm[nz].tolist())
        rep_mult[rg] = x2[nf + ng:]
        rep_mult[g] = 0.0
        if not np.any(rep_mult > 0.5):
            break

    idx = np.asarray(fixed_idx, np.int64)
    mult = np.asarray(fixed_mult, np.float64)
    if not query.check_package(table, idx, mult):
        return PackageResult(False, idx, mult, 0.0, lp_obj_query,
                             status="refine_package_invalid")
    obj = query.objective_value(table, idx, mult)
    return PackageResult(True, idx, mult, obj, lp_obj_query, status="ok")


def query_attrs(query: PackageQuery, table) -> list:
    attrs = [query.objective_attr]
    for ct in query.constraints:
        if ct.attr is not None and ct.attr not in attrs:
            attrs.append(ct.attr)
    return attrs
