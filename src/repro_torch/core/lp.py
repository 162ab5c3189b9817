"""Revised (Parallel) Dual Simplex with Bound-Flipping Ratio Test —
paper §2.3 + App. B/C.

Solves the package-query LP in bounded standard form:

    min  cᵀx̃   s.t.  bl <= Ãx̃ <= bu,   0 <= x̃ <= ũ

internally rewritten (Appendix B.1) with slacks s = Ãx̃:

    min cᵀx   s.t.  Ax = 0,  l <= x <= u,   A = [-Ã | I],  x = [x̃ | s],
    l = [0 | bl], u = [ũ | bu].

Structure exploited exactly as the paper does:
  * m is tiny (3–20) and n is huge -> the basis inverse is a dense m×m
    matrix (App. C.2),
  * phase-1 is free: ANY nonsingular basis is dual-feasible after setting
    each nonbasic variable to the bound matching the sign of its reduced
    cost (App. C.1) — this is also what makes warm starting safe,
  * the two O(n) steps per iteration — pricing (alpha = rho @ A) and the
    BFRT breakpoint scan — are embarrassingly parallel over n (App. C.3);
    vectorised here, and on the GPU they run as the CUDA kernels of
    ``repro_torch.kernels`` (driven by ``core.lp_kernel``).

Revised-simplex invariants (maintained between pivots, App. C custom loop):
  * ``Binv``    — basis inverse, updated by a Sherman–Morrison /
    product-form rank-1 update per pivot (O(m^2)), refactorized from
    scratch every ``REFACTOR_EVERY`` pivots for f64 stability;
  * ``d``       — reduced costs c - Aᵀy, updated by one O(n) axpy
    ``d -= theta * alpha`` per pivot (exact zeros pinned on the basis);
  * ``y``       — duals, updated by ``y += theta * rho`` (O(m));
  * ``xB``      — basic primal values, updated incrementally after bound
    flips (O(m * |flips|) in the numpy twin; one masked matvec in the
    device twin) and the basis exchange (O(m)).
  The ONLY O(mn) sweep of A inside the pivot loop is the pricing pass
  ``alpha = rho @ A`` (the CUDA kernel in ``repro_torch.kernels.pricing``).
  Whenever optimality or dual unboundedness is about to be declared on
  stale (rank-1-updated) factors, the engine refactorizes first and
  re-checks, so the ``verify_optimality`` certificate is always produced
  from a fresh factorization.

Warm-start contract:
  ``solve_lp_np`` / ``solve_lp_kernel`` accept
  ``warm_start=`` — an ``LPResult``, a ``WarmStart``, or a
  ``(basis, at_upper)`` tuple.  ``basis`` must hold m column indices into
  THIS LP's n+m columns (callers re-map indices when the column set
  changed, cf. ``core.shading.map_warm_basis``); ``at_upper`` is an
  optional (n+m,) hint used only for columns with a ~zero reduced cost.
  The engine validates the basis (shape, uniqueness, nonsingularity,
  no dual-infeasible column pinned at an infinite bound) and silently
  falls back to the cold all-slack start when invalid — a warm start can
  only change the iteration count, never the answer.

Three twin implementations with identical pivot rules:
  solve_lp_np      — numpy (host), used by branch & bound re-solves, the
                     Dual Reducer, the shading cascade's default layer
                     solver, and as the oracle;
  solve_lp_kernel  — the device twin (``repro_torch.core.lp_kernel``):
                     pricing and BFRT run as hand-written CUDA kernels;
  solve_lp         — the reference's jitted twin: one lane of the batched
                     engine (``core.lp_batch``, ``csrc/lp_batch.cu``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.guard import NumericalMonitor, SolveBudget, THETA_EPS
from repro_torch.runtime import faults

OPTIMAL, ITER_LIMIT, INFEASIBLE, BUDGET = 0, 1, 2, 3
_TOL = 1e-9
REFACTOR_EVERY = 64   # pivots between full refactorizations (f64 stability)


@dataclasses.dataclass
class LPResult:
    status: int
    x: np.ndarray            # primal solution over the original n variables
    obj: float               # objective in the ORIGINAL sense (pre-negation)
    iters: int
    basis: np.ndarray        # final basis (indices into n+m)
    at_upper: np.ndarray     # nonbasic-at-upper flags (n+m)
    y: np.ndarray            # duals (m,)
    notes: Tuple[str, ...] = ()   # solver events (warm rejection, stalls,
                                  # budget truncation) for the SolveReport

    @property
    def feasible(self) -> bool:
        return self.status == OPTIMAL

    @property
    def warm(self) -> "WarmStart":
        """Warm-start handle for a sibling LP over the same columns."""
        return WarmStart(self.basis, self.at_upper)


@dataclasses.dataclass
class WarmStart:
    """Starting basis for the dual simplex (see module docstring)."""
    basis: np.ndarray
    at_upper: Optional[np.ndarray] = None


def _unpack_warm(warm_start):
    """Accept LPResult / WarmStart / (basis, at_upper) / None."""
    if warm_start is None:
        return None, None
    if hasattr(warm_start, "basis"):
        return warm_start.basis, getattr(warm_start, "at_upper", None)
    basis, at_upper = warm_start
    return basis, at_upper


def standard_form(c, A_t, bl, bu, ub):
    """Build [x̃ | s] arrays. Returns (c_f, A_f, l_f, u_f)."""
    m, n = A_t.shape
    c_f = np.concatenate([c, np.zeros(m)])
    A_f = np.concatenate([-A_t, np.eye(m)], axis=1)
    l_f = np.concatenate([np.zeros(n), bl])
    u_f = np.concatenate([ub, bu])
    return c_f, A_f, l_f, u_f


def row_scaling(A_t) -> np.ndarray:
    """Row equilibration factors: package-query rows can differ by 12+
    orders of magnitude (count=1 vs FLOPs=1e12); unscaled, the transformed
    pivot rows lose the small rows to cancellation."""
    mx = np.max(np.abs(A_t), axis=1)
    return np.where(mx > 0, 1.0 / mx, 1.0)


def _cold_start(cf, l, n, N):
    """All-slack basis, nonbasic at the bound matching sign(c) (App. C.1)."""
    basis = np.arange(n, N)
    in_basis = np.zeros(N, bool)
    in_basis[basis] = True
    at_upper = np.zeros(N, bool)
    at_upper[:n] = (cf[:n] < 0) | np.isinf(l[:n])
    return basis, in_basis, at_upper


def _warm_state(cf, A, l, u, warm_basis, at_upper_hint, tol):
    """Validate a warm basis; returns
    ((basis, in_basis, at_upper, Binv, y, d), None) or (None, reason).

    Dual feasibility is restored for free by placing every nonbasic column
    at the bound matching the sign of its reduced cost; the ``at_upper``
    hint only decides columns whose reduced cost is ~zero (degenerate),
    which preserves the warm solve's primal point.  The factors computed
    for validation (Binv, y, d) are returned so the solver can seed its
    state without refactorizing again.

    A rejected basis is never an error — the caller falls back to the
    cold all-slack start — but it is no longer *silent*: the reason is
    surfaced through ``LPResult.notes`` / the SolveReport so a bad basis
    can never be proceeded on unnoticed.
    """
    m, N = A.shape
    basis = np.asarray(warm_basis, np.int64).ravel()
    if basis.shape != (m,):
        return None, f"basis shape {basis.shape} != ({m},)"
    if basis.min() < 0 or basis.max() >= N or len(np.unique(basis)) != m:
        return None, "basis indices out of range or duplicated"
    try:
        Binv = np.linalg.inv(A[:, basis])
    except np.linalg.LinAlgError:
        return None, "singular basis"
    if not np.all(np.isfinite(Binv)) or np.abs(Binv).max() > 1e12:
        return None, "ill-conditioned basis"
    in_basis = np.zeros(N, bool)
    in_basis[basis] = True
    y = Binv.T @ cf[basis]
    d = cf - A.T @ y
    d[basis] = 0.0
    hint = np.zeros(N, bool)
    if at_upper_hint is not None:
        h = np.asarray(at_upper_hint, bool).ravel()
        if h.shape == (N,):
            hint = h.copy()
    at_upper = np.where(d < -tol, True, np.where(d > tol, False, hint))
    at_upper |= np.isinf(l)            # -inf lower: must sit at upper
    at_upper &= ~np.isinf(u)           # +inf upper: must sit at lower
    # a nonbasic column whose reduced-cost sign demands an infinite bound
    # cannot be made dual-feasible by bound placement -> reject the basis
    bad = (~in_basis) & (((d < -tol) & np.isinf(u))
                         | ((d > tol) & np.isinf(l))
                         | (np.isinf(l) & np.isinf(u)))
    if np.any(bad):
        return None, "dual-infeasible column pinned at an infinite bound"
    at_upper[in_basis] = False
    return (basis.copy(), in_basis, at_upper, Binv, y, d), None


def fill_warm_basis(new_basis, n_new: int, m: int):
    """Shared warm-basis remap tail (shading / dual_reducer): replace
    unmapped (-1) entries with unused slack columns of the new LP;
    returns an int64 basis or None if duplicates remain."""
    used = set(int(b) for b in new_basis if b >= 0)
    free = [n_new + i for i in range(m) if n_new + i not in used]
    out = []
    for b in new_basis:
        if b < 0:
            if not free:
                return None
            b = free.pop(0)
        out.append(int(b))
    if len(set(out)) != m:
        return None
    return np.asarray(out, np.int64)


def _prep(c, A_t, bl, bu, ub, lb, warm_start, tol=1e-7):
    """Shared solver setup: scale, standard form, warm-basis validation.

    Returns (arrs, scale, m, n, (basis0, at_upper0, winit, wnote)) where
    arrs is None for an infeasible box, winit is the validated warm state
    (basis, in_basis, at_upper, Binv, y, d) or None for a cold start, and
    wnote records why a requested warm basis was rejected (else None).
    """
    c = np.asarray(c, np.float64)
    A_t = np.atleast_2d(np.asarray(A_t, np.float64))
    m, n = A_t.shape
    scale = row_scaling(A_t)
    A_t = A_t * scale[:, None]
    bl = np.asarray(bl, np.float64) * scale
    bu = np.asarray(bu, np.float64) * scale
    cf, A, l, u = standard_form(c, A_t, bl, bu, np.asarray(ub, np.float64))
    if lb is not None:
        l[:n] = lb
    N = n + m
    if np.any(l > u + tol):
        return None, scale, m, n, None
    wb, wh = _unpack_warm(warm_start)
    winit, wnote = (None, None) if wb is None else \
        _warm_state(cf, A, l, u, wb, wh, tol)
    if wnote is not None:
        wnote = f"warm_start_rejected: {wnote}; cold start used"
    if winit is None:
        basis0, _, at_upper0 = _cold_start(cf, l, n, N)
    else:
        basis0, _, at_upper0 = winit[:3]
    return (cf, A, l, u), scale, m, n, (basis0, at_upper0, winit, wnote)


def solve_lp_np(c, A_t, bl, bu, ub, *, lb: Optional[np.ndarray] = None,
                max_iters: int = 5000, tol: float = 1e-7,
                warm_start=None,
                refactor_every: int = REFACTOR_EVERY,
                budget: Optional[SolveBudget] = None,
                monitor: Optional[NumericalMonitor] = None) -> LPResult:
    """Bounded revised dual simplex with BFRT (numpy twin).

    Maintains Binv (rank-1 product-form updates), reduced costs d (one
    O(n) axpy per pivot) and xB (O(m*|flips|)) incrementally; the pricing
    matvec ``rho @ A`` is the only O(mn) work per iteration.

    ``budget=`` bounds wall clock and pivots (status BUDGET on
    truncation); ``monitor=`` collects numerical-health events.  The
    solver checks Binv residual drift every ``monitor.drift_check_every``
    pivots and tracks degenerate-pivot streaks: a streak of
    ``stall_refactor`` forces a refactorization, ``stall_bland``
    escalates to Bland's-rule pivoting (smallest-index row/column, no
    bound flips) until a non-degenerate pivot resumes progress.
    """
    arrs, scale, m, n, start = _prep(c, A_t, bl, bu, ub, lb, warm_start,
                                     tol)
    N = n + m
    if arrs is None:
        return LPResult(INFEASIBLE, np.zeros(n), 0.0, 0,
                        np.arange(n, N), np.zeros(N, bool), np.zeros(m))
    cf, A, l, u = arrs
    basis0, at_upper0, winit, wnote = start
    notes = [] if wnote is None else [wnote]
    mon = monitor if monitor is not None else NumericalMonitor()
    if budget is not None:
        budget.start()
    basis = basis0.copy()
    at_upper = at_upper0.copy()
    in_basis = np.zeros(N, bool)
    in_basis[basis] = True
    if winit is not None:
        # reuse the factors computed during warm-basis validation
        _, _, _, Binv, y, d = winit
        xN = np.where(in_basis, 0.0, np.where(at_upper, u, l))
        xN[basis] = 0.0
        xB = -Binv @ (A @ xN)
        since = 0
    else:
        Binv = np.eye(m)
        xB = np.zeros(m)
        y = np.zeros(m)
        d = cf.copy()
        since = refactor_every      # force a full factorization first

    def refresh():
        nonlocal Binv, xB, y, d, since
        Binv = np.linalg.inv(A[:, basis])
        xN = np.where(in_basis, 0.0, np.where(at_upper, u, l))
        xN[basis] = 0.0
        xB = -Binv @ (A @ xN)
        y = Binv.T @ cf[basis]
        d = cf - A.T @ y
        d[basis] = 0.0
        since = 0

    status = ITER_LIMIT
    iters = 0
    stall = 0
    bland = False
    for iters in range(1, max_iters + 1):
        if budget is not None and (budget.out_of_time()
                                   or iters > budget.remaining_pivots()):
            status = BUDGET
            notes.append(f"budget: truncated at pivot {iters - 1}")
            break
        if since >= refactor_every:
            refresh()
        Binv = faults.perturb(faults.BINV, Binv)
        if iters % mon.drift_check_every == 0:
            resid = float(np.abs(Binv @ A[:, basis] - np.eye(m)).max())
            if mon.record_resid(resid):
                if mon.drift_refactors <= 3:
                    notes.append(f"drift: |BinvB-I|={resid:.2e} -> "
                                 "refactorize")
                refresh()
        lB, uB = l[basis], u[basis]
        viol_lo = lB - xB
        viol_hi = xB - uB
        viol = np.maximum(viol_lo, viol_hi)
        r = int(np.argmax(viol))
        if viol[r] <= tol and since > 0:
            # about to declare optimality on drifted factors: refactorize
            # and re-check so the certificate is exact
            refresh()
            viol_lo = lB - xB
            viol_hi = xB - uB
            viol = np.maximum(viol_lo, viol_hi)
            r = int(np.argmax(viol))
        if viol[r] <= tol:
            status = OPTIMAL
            break
        if bland:
            # Bland anti-cycling: leave the violated row whose BASIC
            # VARIABLE index is smallest — row position alone does not
            # carry the finiteness guarantee (bases reorder across pivots)
            r = int(np.argmin(np.where(viol > tol, basis, N)))
        above = viol_hi[r] >= viol_lo[r]
        delta = xB[r] - (uB[r] if above else lB[r])
        s = 1.0 if delta > 0 else -1.0

        rho = Binv[r]
        alpha = rho @ A           # pricing: the single O(mn) sweep, ∥ over n

        sa = s * alpha
        elig = (~in_basis) & (
            ((~at_upper) & (sa > tol)) | (at_upper & (sa < -tol)))
        if not np.any(elig):
            if since > 0:         # could be drift: retry on fresh factors
                refresh()
                continue
            status = INFEASIBLE
            break
        ratio = np.where(elig, d / np.where(np.abs(sa) > tol, sa, 1.0), np.inf)
        ratio = np.where(elig, np.maximum(ratio, 0.0), np.inf)

        if bland:
            # Bland's rule: smallest-index min-ratio column, no bound
            # flips — finite (anti-cycling) at the cost of progress/pivot
            rmin = float(np.min(ratio))
            q = int(np.argmax(elig & (ratio <= rmin + 1e-12)))
            flips = np.empty(0, np.int64)
            mon.bland_pivots += 1
        else:
            # ---- BFRT: walk breakpoints in ratio order, flipping bounds
            # while the remaining infeasibility budget allows (App. C.3).
            width = u - l
            flip_cost = np.full(N, np.inf)
            flip_cost[elig] = np.abs(alpha[elig]) * width[elig]
            order = np.argsort(ratio, kind="stable")
            k_elig = int(np.sum(elig))
            cand = order[:k_elig]
            csum = np.cumsum(flip_cost[cand])
            flip_budget = abs(delta)
            cross = int(np.searchsorted(csum, flip_budget - 1e-12))
            if cross >= k_elig:
                if since > 0:     # dual unbounded on stale factors: re-check
                    refresh()
                    continue
                status = INFEASIBLE   # dual unbounded: flips cannot absorb
                break
            q = int(cand[cross])
            flips = cand[:cross]

        # ---- incremental pivot (no inv, no full d recompute) ----
        leave = basis[r]
        w = Binv @ A[:, q]                    # entering column in B coords
        if abs(w[r]) < 1e-11:
            # numerically unsafe pivot on drifted factors; fresh factors
            # guarantee |w[r]| = |alpha_q| > tol.  Checked BEFORE any flip
            # is applied so the retry restarts from a consistent state.
            if since > 0:
                refresh()
                continue
            break                             # cannot happen; keep ITER_LIMIT
        if len(flips):
            # bound flips move xB by -Binv A[:,flips] dx: O(m * |flips|)
            dxf = np.where(at_upper[flips], l[flips] - u[flips],
                           u[flips] - l[flips])
            xB -= Binv @ (A[:, flips] @ dxf)
            at_upper[flips] = ~at_upper[flips]
        target = uB[r] if above else lB[r]
        t = (xB[r] - target) / w[r]
        xq = u[q] if at_upper[q] else l[q]
        xB -= t * w
        xB[r] = xq + t
        theta = d[q] / w[r]
        d -= theta * alpha                    # one O(n) axpy
        d[q] = 0.0
        d[leave] = -theta
        y += theta * rho
        # Sherman–Morrison / product-form rank-1 update of Binv
        Binv_r = Binv[r] / w[r]
        Binv -= np.outer(w, Binv_r)
        Binv[r] = Binv_r
        at_upper[leave] = above
        at_upper[q] = False
        in_basis[leave] = False
        in_basis[q] = True
        basis[r] = q
        since += 1

        # ---- anti-cycling: degenerate (theta ~ 0) pivot streaks ----
        if abs(theta) <= THETA_EPS:
            stall += 1
            if stall == mon.stall_refactor:
                mon.stall_refactors += 1
                mon.stall_events += 1
                since = refactor_every          # force refresh next pivot
            if stall >= mon.stall_bland and not bland:
                bland = True
                mon.stall_events += 1
                notes.append(f"stall: {stall} degenerate pivots -> "
                             "Bland's rule")
        elif stall:
            stall = 0
            bland = False                       # progress resumed

    if budget is not None:
        budget.charge_pivots(iters)
    # final answer always from a fresh factorization
    Binv = np.linalg.inv(A[:, basis])
    xN = np.where(in_basis, 0.0, np.where(at_upper, u, l))
    xN[basis] = 0.0
    xB = -Binv @ (A @ xN)
    x = xN.copy()
    x[basis] = xB
    y = Binv.T @ cf[basis]
    obj_min = float(cf @ np.where(np.isfinite(x), x, 0.0))
    return LPResult(status, x[:n], obj_min, iters, basis.copy(),
                    at_upper.copy(), y * scale,   # duals in original units
                    notes=tuple(notes))


def solve_lp(c, A_t, bl, bu, ub, *, lb: Optional[np.ndarray] = None,
             max_iters: int = 5000, warm_start=None, mesh=None,
             budget: Optional[SolveBudget] = None,
             monitor: Optional[NumericalMonitor] = None,
             device="cuda") -> LPResult:
    """The reference's jitted twin (``repro.core.lp.solve_lp``): one lane
    of the batched engine (``core.lp_batch``) on ``device`` -- a launch of
    ``csrc/lp_batch.cu`` on a CUDA device, its plain version on the CPU.
    Same conventions as ``solve_lp_np``, including the warm-start and
    budget/monitor contracts: tolerance 1e-7, the pivot cap
    ``budget.lp_iter_cap(max_iters)`` and no shared cap, as in the
    reference.  ``mesh=`` (the distributed pricing backend) is not ported
    yet and raises."""
    if mesh is not None:
        raise NotImplementedError(
            "solve_lp(mesh=) is not ported yet (ROADMAP queue 1, item 6: "
            "distributed pricing)")
    from repro_torch.core.lp_batch import _dispatch, _monitor
    from repro_torch.device import resolve_device
    c = np.asarray(c, np.float64)
    A_t = np.atleast_2d(np.asarray(A_t, np.float64))
    m, n = A_t.shape
    dev = resolve_device(device)
    lb_row = np.zeros(n) if lb is None else np.asarray(lb, np.float64)
    ub_row = np.asarray(ub, np.float64)
    cap = max_iters
    if budget is not None:
        budget.start()
        if budget.out_of_time() or budget.remaining_pivots() <= 0:
            # the reference returns the starting basis it prepared
            arrs, _, _, _, start = _prep(c, A_t, bl, bu, ub_row, lb_row,
                                         warm_start)
            if arrs is None:
                return LPResult(INFEASIBLE, np.zeros(n), 0.0, 0,
                                np.arange(n, n + m), np.zeros(n + m, bool),
                                np.zeros(m))
            basis0, at_upper0, _, wnote = start
            notes = ([] if wnote is None else [wnote]) \
                + ["budget: exhausted before LP solve"]
            return LPResult(BUDGET, np.zeros(n), 0.0, 0,
                            np.asarray(basis0), np.asarray(at_upper0, bool),
                            np.zeros(m), notes=tuple(notes))
        cap = budget.lp_iter_cap(max_iters)
    results, lanes, _ = _dispatch(
        c, A_t, bl, bu, ub_row[None], lb_row[None], np.full(1, 1e-7),
        [warm_start], cap=cap, pivot_cap=None,
        refactor_every=REFACTOR_EVERY, device=dev)
    if results[0] is not None:
        return results[0]                      # an infeasible box
    lane = lanes[0]
    st, notes = lane.status, lane.notes()
    _monitor(monitor, lanes)
    if budget is not None:
        budget.charge_pivots(lane.iters)
        if st == ITER_LIMIT and (cap < max_iters or budget.exhausted()):
            st = BUDGET
            notes.append(f"budget: truncated at pivot cap {cap}")
    return lane.result(st, notes)


# ------------------------------------------------------- certificate check


def verify_optimality(res: LPResult, c, A_t, bl, bu, ub,
                      lb: Optional[np.ndarray] = None,
                      tol: float = 1e-5) -> Tuple[bool, str]:
    """Independent optimality certificate (numpy, no solver internals).

    x* is optimal iff (i) primal feasible and (ii) there exist duals y with
    reduced costs d = c - Aᵀy satisfying d_j >= 0 at lower bounds,
    d_j <= 0 at upper bounds, d_j = 0 for strictly interior x_j.  We check
    the basis-derived y, which by LP theory certifies optimality if valid.
    """
    c = np.asarray(c, np.float64)
    A_t = np.atleast_2d(np.asarray(A_t, np.float64))
    m, n = A_t.shape
    cf, A, l, u = standard_form(c, A_t, np.asarray(bl, np.float64),
                                np.asarray(bu, np.float64),
                                np.asarray(ub, np.float64))
    if lb is not None:
        l[:n] = lb
    x = res.x
    # primal feasibility
    if np.any(x < l[:n] - tol) or np.any(x > u[:n] + tol):
        return False, "primal bounds violated"
    act = A_t @ x
    if np.any(act < np.asarray(bl) - tol) or np.any(act > np.asarray(bu) + tol):
        return False, "constraint bounds violated"
    # dual feasibility + complementary slackness
    sf = np.concatenate([x, act])
    d = cf - A.T @ res.y
    at_lo = sf <= l + tol
    at_hi = sf >= u - tol
    interior = ~(at_lo | at_hi)
    if np.any(np.abs(d[interior]) > tol * (1 + np.abs(cf[interior]))):
        return False, "nonzero reduced cost at interior variable"
    bad_lo = at_lo & ~at_hi & (d < -tol)
    bad_hi = at_hi & ~at_lo & (d > tol)
    if np.any(bad_lo) or np.any(bad_hi):
        return False, "reduced-cost sign violation"
    return True, "optimal certificate valid"
