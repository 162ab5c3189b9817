"""Dual Reducer — paper §2.4, Algorithm 4.

RENS-style heuristic ILP solver: LP relaxation x*, auxiliary LP with
per-variable upper bound E/q (E = ||x*||_1) that spreads the support to
~q variables, then a sub-ILP over the union of both supports; exponential
fallback (double q, uniformly sample additional tuples) guarantees
solvability whenever the full ILP is feasible (up to node limits).

Warm starts (revised dual simplex, core.lp): the auxiliary LP differs
from the first LP ONLY in upper bounds — the textbook dual-simplex
warm-start case — so it reuses lp1's final basis directly; the fallback
sub-ILP root LPs re-map lp1's basis onto the selected columns.  The
caller (progressive_shading) may pass ``warm_start`` to seed lp1 itself
from the last Shading layer's basis.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import ilp as ilp_mod
from repro_torch.core.lp import INFEASIBLE, OPTIMAL, LPResult, WarmStart, \
    fill_warm_basis, solve_lp_np
from repro_torch.core.lp_batch import solve_lp_batch
from repro_torch.core.paql import PackageQuery


@dataclasses.dataclass
class PackageResult:
    feasible: bool
    idx: np.ndarray          # global tuple indices in the package
    mult: np.ndarray         # multiplicities (same length)
    obj: float               # objective in the query's own sense
    lp_obj: float            # LP relaxation bound (query sense) over S
    fallbacks: int = 0
    sub_ilp_size: int = 0
    status: str = ""
    report: Optional[object] = None   # guard.SolveReport (engine.solve)
    lp_warm: Optional[WarmStart] = None   # lp1 final basis (cache artifact)
    ps_stats: Optional[object] = None     # shading.PSStats (cascade solves)

    def integrality_gap(self, eps: float = 0.1) -> float:
        """Paper §4.1 metric vs. this result's own LP bound."""
        return (abs(self.obj) + eps) / (abs(self.lp_obj) + eps)


def _subset_warm(lp1: LPResult, sel: np.ndarray, n: int) -> Optional[WarmStart]:
    """Re-map lp1's basis (over all n columns of S) onto the columns in
    ``sel``; basic columns outside sel become unused slacks."""
    m = len(lp1.y)
    n_sub = len(sel)
    pos = np.full(n, -1, np.int64)
    pos[sel] = np.arange(n_sub)
    new_basis = np.full(m, -1, np.int64)
    for k, j in enumerate(np.asarray(lp1.basis, np.int64)):
        if j >= n:
            new_basis[k] = n_sub + (j - n)
        elif pos[j] >= 0:
            new_basis[k] = pos[j]
    new_basis = fill_warm_basis(new_basis, n_sub, m)
    if new_basis is None:
        return None
    at_upper = np.concatenate([lp1.at_upper[:n][sel], lp1.at_upper[n:]])
    return WarmStart(new_basis, at_upper)


def dual_reducer(query: PackageQuery, table, S: np.ndarray, *, q: int = 500,
                 rng: Optional[np.random.Generator] = None,
                 max_lp_iters: int = 20000,
                 ilp_kwargs: Optional[dict] = None,
                 aux: str = "lp", warm_start=None,
                 budget=None, report=None,
                 ladder: bool = True, aux_rungs: int = 1,
                 batch_backend: str = "auto",
                 device="cuda") -> PackageResult:
    """aux: 'lp' (paper's auxiliary LP, line 4-5) | 'random' (Mini-Exp 4
    ablation: random sample of ~q tuples instead).  warm_start seeds the
    first LP (see module docstring).  ``table`` may be a dict of arrays or
    a Relation: only the <= |S| candidate rows are ever gathered (the
    out-of-core contract — S carries tuple ids, never tuples).

    ``aux_rungs=R`` solves R auxiliary LPs in ONE ``solve_lp_batch``
    dispatch — bound-variants ``ub_j = min(ub, E/(q * 2^j))`` of the
    same (c, A), all warm-started from lp1.  Rung 0 is the paper's
    auxiliary LP; rungs j >= 1 are the supports the exponential
    fallback would otherwise have to re-solve for after doubling q, so
    each fallback round widens ``sel`` from a precomputed rung before
    falling back to random sampling.  ``aux_rungs=1`` is byte-identical
    to the classic single auxiliary solve.  ``device`` (default
    ``"cuda"``) is where flights of more than two lanes run, the rungs'
    and the sub-ILP's B&B waves.

    Guard integration: ``budget`` (guard.SolveBudget) is threaded through
    every LP and the sub-ILPs; ``report`` (guard.SolveReport) accumulates
    LP stats and degradation rungs.  With ``ladder=True`` (default) a
    failed solve degrades instead of failing dry:

      * lp1 INFEASIBLE      -> one warm retry with relaxed tolerance
        (rung ``dr_relax_tol``);
      * sub-ILP out of budget / infeasible with no widening left ->
        round-and-repair lp1's relaxation over the full candidate set
        (``_swap_search``) and return it flagged ``degraded_rounded``.
    """
    rng = rng or np.random.default_rng(0)
    ilp_kwargs = dict(ilp_kwargs or {})
    ilp_kwargs.setdefault("device", device)
    monitor = report.monitor if report is not None else None
    S = np.asarray(S)
    n = len(S)
    c, A, bl, bu, ub = query.matrices(table, S)

    lp1 = solve_lp_np(c, A, bl, bu, ub, max_iters=max_lp_iters,
                      warm_start=warm_start, budget=budget,
                      monitor=monitor)
    if report is not None:
        report.absorb_lp(lp1)
    if lp1.status == INFEASIBLE and ladder:
        # tight queries can be declared infeasible by a hair: retry warm
        # with a relaxed tolerance before giving up (ladder rung 1)
        lp1 = solve_lp_np(c, A, bl, bu, ub, max_iters=max_lp_iters,
                          tol=1e-5, warm_start=lp1, budget=budget,
                          monitor=monitor)
        if report is not None:
            report.rung("dr_relax_tol",
                        detail=f"retry status={lp1.status}")
            report.absorb_lp(lp1)
    if lp1.status != OPTIMAL:
        status = "lp_budget" if lp1.status == ilp_mod.BUDGET \
            else "lp_infeasible"
        return PackageResult(False, np.zeros(0, np.int64), np.zeros(0),
                             0.0, 0.0, status=status)
    lp_obj_query = -lp1.obj if query.maximize else lp1.obj

    tol = 1e-9
    support = lp1.x > tol
    aux_supports = []          # precomputed widening rungs (fallback rounds)
    if aux == "random":
        support |= rng.random(n) < q / max(n, 1)
    else:
        E = float(np.sum(lp1.x))
        rungs = max(1, int(aux_rungs))
        # rung j caps every variable at E/(q*2^j): the support the
        # exponential fallback would need after j doublings of q.  All
        # rungs are bound-variants of one (c, A) warm-started from lp1:
        # one batched dispatch (sequential solve_lp_np when rungs == 1).
        ub_variants = [np.minimum(ub, max(E / (max(q, 1) * 2 ** j), 1e-9))
                       for j in range(rungs)]
        auxs = solve_lp_batch(c, A, bl, bu, ub_variants,
                              max_iters=max_lp_iters,
                              warm_starts=[lp1] * rungs, budget=budget,
                              monitor=monitor, backend=batch_backend,
                              device=device)
        if report is not None:
            report.absorb_batch(auxs)
        for jr, lp2 in enumerate(auxs):
            if lp2.status != OPTIMAL:
                continue
            if jr == 0:
                support |= lp2.x > tol
            else:
                aux_supports.append(lp2.x > tol)
    sel = np.flatnonzero(support)

    def _degraded_rounding(n_sel: int, fallbacks: int, why: str):
        """Terminal ladder rung: round-and-repair lp1's relaxation."""
        xr, objr = ilp_mod._swap_search(lp1.x, c, A, bl, bu, np.zeros(n),
                                        ub, 1e-6)
        if xr is None:
            return None
        if report is not None:
            report.rung("degraded_rounded", degrades=True, detail=why)
        nz = xr > 0.5
        obj_query = -objr if query.maximize else objr
        return PackageResult(True, S[nz], xr[nz], obj_query, lp_obj_query,
                             fallbacks, n_sel, status="degraded_rounded",
                             lp_warm=lp1.warm)

    fallbacks = 0
    while True:
        sub = S[sel]
        cs, As, _, _, ubs = query.matrices(table, sub)
        res = ilp_mod.solve_ilp(cs, As, bl, bu, ubs,
                                warm_start=_subset_warm(lp1, sel, n),
                                budget=budget, monitor=monitor,
                                **ilp_kwargs)
        if report is not None:
            report.ilp_nodes += res.nodes
        if res.feasible:
            mult = res.x
            nz = mult > 0.5
            obj_query = -res.obj if query.maximize else res.obj
            return PackageResult(True, sub[nz], mult[nz], obj_query,
                                 lp_obj_query, fallbacks, len(sel),
                                 status="ok", lp_warm=lp1.warm)
        out_of_budget = budget is not None and budget.exhausted()
        if len(sel) >= n or out_of_budget:
            if ladder:
                why = "budget exhausted" if out_of_budget else \
                    "sub-ILP infeasible at full width"
                deg = _degraded_rounding(len(sel), fallbacks, why)
                if deg is not None:
                    return deg
            status = "budget_exhausted" if out_of_budget \
                and len(sel) < n else "ilp_infeasible"
            return PackageResult(False, np.zeros(0, np.int64), np.zeros(0),
                                 0.0, lp_obj_query, fallbacks, len(sel),
                                 status=status)
        # fallback: double q, sample additional tuples uniformly (lines 9-14)
        fallbacks += 1
        q = min(2 * max(q, 1), n)
        if aux_supports:
            # a precomputed aux rung already solved this q-doubling:
            # widen deterministically before the random top-up
            sel = np.union1d(sel, np.flatnonzero(aux_supports.pop(0)))
        remaining = np.setdiff1d(np.arange(n), sel, assume_unique=False)
        need = min(max(q - len(sel), 0), len(remaining))
        if need > 0:
            extra = rng.choice(remaining, size=need, replace=False)
            sel = np.union1d(sel, extra)
        else:
            sel = np.arange(n)
