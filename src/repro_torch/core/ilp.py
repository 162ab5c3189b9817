"""Branch & bound ILP solver over the bounded-variable LP relaxation.

This stands in for the paper's "black-box ILP solver" (Gurobi).  Package
queries produce ILPs with a handful of constraints, so LP re-solves are
cheap; best-first search with a most-fractional branching rule and a
round-and-check incumbent heuristic handles the Dual Reducer sub-ILPs
(q ≈ 500 variables) comfortably.

Every node LP differs from its parent's only in one variable's bounds, so
node re-solves (and the diving / feasibility-pump LPs) are warm-started
from the parent basis — the textbook dual-simplex case (core.lp); the
root accepts an external ``warm_start`` (Dual Reducer passes lp1's basis
re-mapped onto the sub-ILP columns).

Minimisation form throughout (PackageQuery.matrices already negates
MAXIMIZE objectives).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from typing import Optional

import numpy as np

from repro_torch.core.lp import solve_lp_np, BUDGET, OPTIMAL, INFEASIBLE
from repro_torch.core.lp_batch import solve_lp_batch

ILP_OPTIMAL, ILP_FEASIBLE, ILP_INFEASIBLE, ILP_LIMIT = 0, 1, 2, 3


@dataclasses.dataclass
class ILPResult:
    status: int
    x: np.ndarray
    obj: float               # minimisation objective
    nodes: int
    lp_obj: float            # root relaxation bound
    lp_iters: int = 0        # total simplex iterations across node re-solves

    @property
    def feasible(self) -> bool:
        return self.status in (ILP_OPTIMAL, ILP_FEASIBLE)


def _round_feasible(x, c, A, bl, bu, lb, ub, tol):
    xi = np.clip(np.round(x), lb, ub)
    act = A @ xi
    if np.all(act >= bl - tol) and np.all(act <= bu + tol):
        return xi, float(c @ xi)
    return None, np.inf


def _dive(c, A, bl, bu, lb, ub, tol, max_lp_iters, max_steps=400,
          warm_start=None, budget=None, probe_batch: bool = False):
    """LP-guided fractional diving.

    Package-query LPs have at most m fractional (basic) variables, so
    repeatedly pinning the most-fractional variable to a nearby integer and
    re-solving converges quickly to an integer-feasible point when one is
    near the LP face — the workhorse incumbent finder for tight BETWEEN
    windows where naive rounding fails.

    ``probe_batch=True`` solves both branching probes (pure bound
    variants of the current dive LP) as one ``solve_lp_batch`` dispatch
    and keeps the first OPTIMAL one in today's preference order.
    """
    lbd, ubd = lb.copy(), ub.copy()
    warm = warm_start
    for _ in range(max_steps):
        res = solve_lp_np(c, A, bl, bu, ubd, lb=lbd, max_iters=max_lp_iters,
                          warm_start=warm, budget=budget)
        if res.status != OPTIMAL:
            return None, np.inf
        warm = res
        x = res.x
        frac = np.abs(x - np.round(x))
        j = int(np.argmax(frac))
        if frac[j] < tol:
            xi, obj = _round_feasible(x, c, A, bl, bu, lbd, ubd, tol)
            if xi is not None:
                return xi, obj
            return None, np.inf
        r = np.round(x[j])
        # try nearest integer first, fall back to the other side
        variants = []
        for v in (r, np.floor(x[j]) if r > x[j] else np.ceil(x[j])):
            v = float(np.clip(v, lbd[j], ubd[j]))
            lb2, ub2 = lbd.copy(), ubd.copy()
            lb2[j] = ub2[j] = v
            variants.append((lb2, ub2))
        if probe_batch:
            probes = solve_lp_batch(
                c, A, bl, bu, [vv[1] for vv in variants],
                [vv[0] for vv in variants], max_iters=max_lp_iters,
                warm_starts=[warm] * len(variants))
        else:
            probes = None
        for i, (lb2, ub2) in enumerate(variants):
            probe = probes[i] if probes is not None else solve_lp_np(
                c, A, bl, bu, ub2, lb=lb2, max_iters=max_lp_iters,
                warm_start=warm)
            if probe.status == OPTIMAL:
                lbd, ubd = lb2, ub2
                warm = probe
                break
        else:
            return None, np.inf
    return None, np.inf


def _violation(act, bl, bu):
    return np.sum(np.maximum(bl - act, 0) + np.maximum(act - bu, 0))


def _swap_step(x, c, A, bl, bu, lb, ub, *, improve: bool):
    """One best swap (dec a / inc b, incl. pure inc/dec).

    improve=False: minimise total constraint violation (repair mode).
    improve=True : minimise objective among moves that keep feasibility.
    Returns (new_x, improved?).  Vectorised over all O(|pkg| * n) moves.
    """
    act = A @ x
    dec = np.flatnonzero(x > lb + 0.5)          # can decrement
    inc = np.flatnonzero(x < ub - 0.5)          # can increment
    if len(dec) == 0 and len(inc) == 0:
        return x, False
    # pad with a "no-op" pseudo-variable (zero column)
    Ad = np.concatenate([A[:, dec], np.zeros((A.shape[0], 1))], axis=1)
    Ai = np.concatenate([A[:, inc], np.zeros((A.shape[0], 1))], axis=1)
    cd = np.concatenate([c[dec], [0.0]])
    ci = np.concatenate([c[inc], [0.0]])
    # new activity for every (a, b): act - A[:,a] + A[:,b]
    na = act[:, None, None] - Ad[:, :, None] + Ai[:, None, :]
    viol = (np.maximum(bl[:, None, None] - na, 0)
            + np.maximum(na - bu[:, None, None], 0)).sum(axis=0)
    dobj = -cd[:, None] + ci[None, :]
    if improve:
        feas = viol <= 1e-9
        dobj = np.where(feas, dobj, np.inf)
        a, b = np.unravel_index(np.argmin(dobj), dobj.shape)
        if not np.isfinite(dobj[a, b]) or dobj[a, b] >= -1e-12:
            return x, False
    else:
        cur = _violation(act, bl, bu)
        score = viol + 1e-12 * dobj             # tie-break toward objective
        a, b = np.unravel_index(np.argmin(score), score.shape)
        if viol[a, b] >= cur - 1e-12:
            return x, False
    x = x.copy()
    if a < len(dec):
        x[dec[a]] -= 1
    if b < len(inc):
        x[inc[b]] += 1
    return x, True


def _swap_search(x0, c, A, bl, bu, lb, ub, tol, *, max_moves=200):
    """Min-conflicts repair followed by 1-swap objective improvement."""
    x = np.clip(np.round(x0), lb, ub)
    for _ in range(max_moves):
        if _violation(A @ x, bl, bu) <= tol:
            break
        x, moved = _swap_step(x, c, A, bl, bu, lb, ub, improve=False)
        if not moved:
            return None, np.inf
    if _violation(A @ x, bl, bu) > tol:
        return None, np.inf
    for _ in range(max_moves):
        x, moved = _swap_step(x, c, A, bl, bu, lb, ub, improve=True)
        if not moved:
            break
    return x, float(c @ x)


def _feasibility_pump(c, A, bl, bu, lb, ub, tol, max_lp_iters,
                      max_rounds=120, seed=0, warm_start=None,
                      budget=None):
    """Objective feasibility pump (Fischetti-Glover-Lodi) for the tight
    BETWEEN-window packages where rounding/diving stall.

    Alternates LP projection and rounding, minimising an L1 distance to the
    current integer point blended with the (normalised) true objective;
    random flips break cycles.
    """
    rng = np.random.default_rng(seed)
    n = len(c)
    cn = c / (np.linalg.norm(c) + 1e-12)
    res = solve_lp_np(c, A, bl, bu, ub, lb=lb, max_iters=max_lp_iters,
                      warm_start=warm_start, budget=budget)
    if res.status != OPTIMAL:
        return None, np.inf
    x_tilde = np.clip(np.round(res.x), lb, ub)
    w = 0.5
    last = None
    for it in range(max_rounds):
        act = A @ x_tilde
        if np.all(act >= bl - tol) and np.all(act <= bu + tol):
            return x_tilde, float(c @ x_tilde)
        # distance objective: push x toward x_tilde
        c_dist = np.where(x_tilde <= lb + 0.5, 1.0,
                          np.where(x_tilde >= ub - 0.5, -1.0, 0.0))
        # NOTE: the objective changes between pump rounds, so only the
        # previous pump LP's basis (not its at_upper pattern, which the
        # engine re-derives from the new reduced costs) carries over.
        res = solve_lp_np(c_dist + w * cn, A, bl, bu, ub, lb=lb,
                          max_iters=max_lp_iters, warm_start=res,
                          budget=budget)
        if res.status != OPTIMAL:
            return None, np.inf
        new_tilde = np.clip(np.round(res.x), lb, ub)
        if last is not None and np.array_equal(new_tilde, last):
            # cycle: flip the T components with largest rounding error
            err = np.abs(res.x - new_tilde)
            T = int(rng.integers(2, 8))
            idx = np.argsort(-err)[:T]
            for j in idx:
                if res.x[j] > new_tilde[j]:
                    new_tilde[j] = min(new_tilde[j] + 1, ub[j])
                else:
                    new_tilde[j] = max(new_tilde[j] - 1, lb[j])
        last = x_tilde
        x_tilde = new_tilde
        w *= 0.7
    return None, np.inf


def solve_ilp(c, A, bl, bu, ub, *, lb: Optional[np.ndarray] = None,
              max_nodes: int = 5000, tol: float = 1e-6,
              time_limit_s: float = 60.0, max_lp_iters: int = 8000,
              warm_start=None, warm_nodes: bool = True,
              budget=None, monitor=None, wave_width: int = 1,
              batch_backend: Optional[str] = None) -> ILPResult:
    """warm_nodes=False disables node-LP warm starting (benchmark knob).

    ``budget=`` (a ``guard.SolveBudget``) clamps the node/time limits to
    what remains, charges every explored node against the shared node
    budget, and threads the pivot budget through the root/node/heuristic
    LPs — a budget-exhausted search returns ILP_LIMIT (with the incumbent
    if one exists) instead of running past the deadline.

    ``wave_width=W`` explores the frontier in waves: the W best-bound
    nodes are popped together and their child LPs — pure bound-variants
    of one shared ``(c, A)``, each warm-started from its parent — are
    solved as ONE ``solve_lp_batch`` dispatch.  ``W=1`` keeps today's
    one-node-at-a-time loop bit-identical (the batch engine degrades to
    the same sequential ``solve_lp_np`` calls); larger W trades a few
    extra node expansions (children of wave-mates can't prune each
    other before solving) for one dispatch per wave.  ``batch_backend``
    overrides the engine choice (default: ``"np"`` for W=1, ``"auto"``
    otherwise).
    """
    c = np.asarray(c, np.float64)
    A = np.atleast_2d(np.asarray(A, np.float64))
    m, n = A.shape
    bl = np.asarray(bl, np.float64)
    bu = np.asarray(bu, np.float64)
    ub0 = np.asarray(ub, np.float64)
    lb0 = np.zeros(n) if lb is None else np.asarray(lb, np.float64)

    if budget is not None:
        budget.start()
        kw = budget.clamp_ilp_kwargs(dict(time_limit_s=time_limit_s,
                                          max_nodes=max_nodes))
        time_limit_s = kw["time_limit_s"]
        max_nodes = kw["max_nodes"]

    root = solve_lp_np(c, A, bl, bu, ub0, lb=lb0, max_iters=max_lp_iters,
                       warm_start=warm_start, budget=budget,
                       monitor=monitor)
    lp_iters = root.iters
    if root.status == INFEASIBLE:
        return ILPResult(ILP_INFEASIBLE, np.zeros(n), np.inf, 1, np.inf,
                         lp_iters)
    root_obj = root.obj
    if root.status == BUDGET:
        # truncated root relaxation: salvage an incumbent by rounding the
        # (possibly primal-infeasible) iterate, skip the search
        best_x, best_obj = _round_feasible(root.x, c, A, bl, bu, lb0, ub0,
                                           tol)
        if best_x is None:
            best_x, best_obj = _swap_search(root.x, c, A, bl, bu, lb0,
                                            ub0, tol)
        if best_x is None:
            return ILPResult(ILP_LIMIT, np.zeros(n), np.inf, 0, root_obj,
                             lp_iters)
        return ILPResult(ILP_FEASIBLE, best_x, best_obj, 0, root_obj,
                         lp_iters)

    best_x, best_obj = _round_feasible(root.x, c, A, bl, bu, lb0, ub0, tol)
    if best_x is None:
        # swap-based repair + improvement from the rounded LP point
        best_x, best_obj = _swap_search(root.x, c, A, bl, bu, lb0, ub0, tol)
    if best_x is None:
        # randomized-rounding restarts escape repair local minima
        rng = np.random.default_rng(7)
        for _ in range(8):
            frac = root.x - np.floor(root.x)
            xr = np.floor(root.x) + (rng.random(n) < frac)
            jitter = rng.random(n) < (3.0 / max(n, 1))
            xr = np.clip(xr + jitter * rng.integers(-1, 2, n), lb0, ub0)
            bx, bo = _swap_search(xr, c, A, bl, bu, lb0, ub0, tol)
            if bx is not None:
                best_x, best_obj = bx, bo
                break
    if best_x is None:
        best_x, best_obj = _dive(c, A, bl, bu, lb0, ub0, tol, max_lp_iters,
                                 max_steps=4 * m + 8, warm_start=root,
                                 budget=budget,
                                 probe_batch=wave_width > 1)
    if best_x is None:
        best_x, best_obj = _feasibility_pump(c, A, bl, bu, lb0, ub0, tol,
                                             max_lp_iters, warm_start=root,
                                             budget=budget)
    if best_x is not None:
        bx, bo = _swap_search(best_x, c, A, bl, bu, lb0, ub0, tol)
        if bx is not None and bo < best_obj:
            best_x, best_obj = bx, bo

    heap = []
    counter = itertools.count()
    heapq.heappush(heap, (root.obj, next(counter), lb0, ub0, root.x,
                          root.warm))
    nodes = 0
    t0 = time.time()
    status = ILP_OPTIMAL
    wave_width = max(1, int(wave_width))
    if batch_backend is None:
        batch_backend = "np" if wave_width == 1 else "auto"
    while heap:
        # ---- gather one frontier wave: up to W best-bound expansions ----
        wave_specs = []       # (lb2, ub2, parent warm-start)
        expanded = 0
        limit = False
        while heap and expanded < wave_width:
            if nodes >= max_nodes or (time.time() - t0) > time_limit_s or \
                    (budget is not None and budget.exhausted()):
                limit = True
                break
            bound, _, lbn, ubn, xlp, node_warm = heapq.heappop(heap)
            if bound >= best_obj - 1e-9:
                continue
            nodes += 1
            if budget is not None:
                budget.charge_nodes(1)
            frac = np.abs(xlp - np.round(xlp))
            j = int(np.argmax(frac))
            if frac[j] < tol:
                # integral LP solution: new incumbent
                xi = np.round(xlp)
                obj = float(c @ xi)
                if obj < best_obj:
                    best_obj, best_x = obj, xi
                continue
            expanded += 1
            fl = np.floor(xlp[j])
            for lo_j, hi_j in ((lbn[j], fl), (fl + 1, ubn[j])):
                if lo_j > hi_j:
                    continue
                lb2, ub2 = lbn.copy(), ubn.copy()
                lb2[j], ub2[j] = lo_j, hi_j
                # child differs from parent in one variable's bounds
                # only: warm-start the dual simplex from the parent basis
                wave_specs.append(
                    (lb2, ub2, node_warm if warm_nodes else None))
        if limit and not wave_specs:
            status = ILP_LIMIT
            break
        if wave_specs:
            # the whole wave's children are bound-variants of one shared
            # (c, A): one batched dispatch (sequential np loop at W=1)
            ress = solve_lp_batch(
                c, A, bl, bu, [s[1] for s in wave_specs],
                [s[0] for s in wave_specs], max_iters=max_lp_iters,
                warm_starts=[s[2] for s in wave_specs], budget=budget,
                monitor=monitor, backend=batch_backend)
            # vectorized _round_feasible over the wave: one (K, n)
            # round/clip and one matmul per wave instead of per child —
            # acceptance stays sequential (best_obj updates prune later
            # children exactly as the per-child loop did)
            live = [i for i, r in enumerate(ress)
                    if r.status not in (INFEASIBLE, BUDGET)]
            if live:
                XI = np.clip(
                    np.round(np.stack([ress[i].x for i in live])),
                    np.stack([wave_specs[i][0] for i in live]),
                    np.stack([wave_specs[i][1] for i in live]))
                ACT = XI @ A.T
                r_feas = (np.all(ACT >= bl - tol, axis=1)
                          & np.all(ACT <= bu + tol, axis=1))
                r_obj = XI @ c
            ri = {k: j for j, k in enumerate(live)}
            for i, ((lb2, ub2, _), res) in enumerate(zip(wave_specs,
                                                         ress)):
                lp_iters += res.iters
                if res.status == INFEASIBLE:
                    continue
                if res.status == BUDGET:
                    # child bound is unusable and the budget is gone: the
                    # search is incomplete, never claim optimality
                    status = ILP_LIMIT
                    continue
                if res.obj >= best_obj - 1e-9:
                    continue
                j = ri[i]
                if r_feas[j] and r_obj[j] < best_obj:
                    best_obj, best_x = float(r_obj[j]), XI[j]
                heapq.heappush(heap, (res.obj, next(counter), lb2, ub2,
                                      res.x, res.warm))
        if limit:
            status = ILP_LIMIT
            break

    if best_x is None:
        st = ILP_INFEASIBLE if status == ILP_OPTIMAL else ILP_LIMIT
        return ILPResult(st, np.zeros(n), np.inf, nodes, root_obj, lp_iters)
    st = status if status == ILP_LIMIT else ILP_OPTIMAL
    if st == ILP_LIMIT:
        st = ILP_FEASIBLE
    return ILPResult(st, best_x, best_obj, nodes, root_obj, lp_iters)


def brute_force_ilp(c, A, bl, bu, ub) -> ILPResult:
    """Exhaustive oracle for tiny instances (tests only)."""
    c = np.asarray(c, np.float64)
    A = np.atleast_2d(np.asarray(A, np.float64))
    n = A.shape[1]
    ub = np.asarray(ub).astype(int)
    best, best_obj = None, np.inf
    total = int(np.prod(ub + 1))
    assert total <= 2_000_000, "too large for brute force"
    for combo in itertools.product(*[range(u + 1) for u in ub]):
        x = np.asarray(combo, np.float64)
        act = A @ x
        if np.all(act >= np.asarray(bl) - 1e-9) and np.all(
                act <= np.asarray(bu) + 1e-9):
            obj = float(c @ x)
            if obj < best_obj:
                best_obj, best = obj, x
    if best is None:
        return ILPResult(ILP_INFEASIBLE, np.zeros(n), np.inf, total, np.inf)
    return ILPResult(ILP_OPTIMAL, best, best_obj, total, -np.inf)
