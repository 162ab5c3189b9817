"""Solve Guard — budgets, numerical health, and failure semantics.

The paper's headline robustness claim is that Progressive Shading
"gracefully handles tight constraints" where SketchRefine falsely reports
infeasibility (§1, Fig. 9).  This module makes *graceful* a contract the
whole pipeline shares instead of a property of the happy path:

* :class:`SolveBudget` — wall-clock deadline + pivot/node budgets carried
  through every LP twin (``core.lp``, ``core.lp_kernel``), branch &
  bound (``core.ilp``), Dual Reducer and
  the shading cascade.  Budgets are charged by the solvers themselves, so
  one budget object bounds an entire ``engine.solve`` end to end: no LP,
  node loop or cascade layer can hang past the deadline.
* :class:`NumericalMonitor` — configuration + counters for the in-solver
  health checks: ``Binv`` residual-drift detection (forced
  refactorization when the rank-1-updated inverse drifts past
  ``drift_tol``) and pivot-stall streaks (degenerate ``theta == 0``
  pivots), which escalate to a Bland's-rule pivot mode until progress
  resumes so degenerate/tight instances terminate instead of cycling.
* :class:`SolveReport` — the structured answer sheet every
  ``engine.solve`` returns alongside the package: final status, budget
  spent, every degradation-ladder rung taken, numerical events and fault
  retries.  Silent ``ITER_LIMIT`` truncation is gone — a truncated or
  degraded solve says so.

Status contract (what the serving layer may rely on):

``OK``               — package returned and validated; produced by the
                       normal pipeline (warm retries / stall recovery /
                       drift refactorizations do NOT degrade quality).
``DEGRADED``         — a package is returned and satisfies the query's
                       constraints, but a quality-degrading rung fired
                       (budget-truncated search, LP-rounding fallback,
                       budget-skipped cascade layers): the objective may
                       be off-optimal.
``INFEASIBLE``       — the solver concluded no package exists, with the
                       full ladder exhausted and budget remaining on the
                       critical path; safe to surface as "no answer".
``BUDGET_EXHAUSTED`` — budgets ran out before any package was found;
                       the right reaction is retry with a larger budget,
                       not "infeasible".
``ERROR``            — an unexpected exception was contained by the
                       guard; no package.  Never raised to the caller.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

# ------------------------------------------------------------- statuses

OK = "ok"
DEGRADED = "degraded"
INFEASIBLE = "infeasible"
BUDGET_EXHAUSTED = "budget_exhausted"
ERROR = "error"

STATUSES = (OK, DEGRADED, INFEASIBLE, BUDGET_EXHAUSTED, ERROR)

# Numerical-health defaults, shared by the numpy twin (via
# NumericalMonitor defaults) and the device twin (core.lp_kernel).
DRIFT_TOL = 1e-6          # max |Binv @ B - I| before a forced refactorize
DRIFT_CHECK_EVERY = 16    # pivots between residual checks (numpy twin)
STALL_REFACTOR = 12       # degenerate-pivot streak -> force refactorize
STALL_BLAND = 24          # streak -> escalate to Bland's-rule pivoting
THETA_EPS = 1e-12         # |theta| below this = degenerate (no progress)


# --------------------------------------------------------------- budget


@dataclasses.dataclass
class SolveBudget:
    """Wall-clock + pivot + node budget for one end-to-end solve.

    All limits are optional (``None`` = unlimited).  The budget is
    *shared*: every LP call and B&B node loop charges the same object, so
    ``engine.solve`` passes one budget down the cascade and the total
    spend is bounded regardless of how many sub-solves fire.
    """
    deadline_s: Optional[float] = None
    max_pivots: Optional[int] = None
    max_nodes: Optional[int] = None
    pivots_spent: int = 0
    nodes_spent: int = 0
    _t0: Optional[float] = dataclasses.field(default=None, repr=False)

    def start(self) -> "SolveBudget":
        """Arm the wall clock (idempotent — first call wins)."""
        if self._t0 is None:
            self._t0 = time.monotonic()
        return self

    @property
    def elapsed_s(self) -> float:
        return 0.0 if self._t0 is None else time.monotonic() - self._t0

    def remaining_s(self) -> float:
        if self.deadline_s is None:
            return float("inf")
        self.start()
        return self.deadline_s - self.elapsed_s

    def remaining_pivots(self) -> float:
        if self.max_pivots is None:
            return float("inf")
        return self.max_pivots - self.pivots_spent

    def remaining_nodes(self) -> float:
        if self.max_nodes is None:
            return float("inf")
        return self.max_nodes - self.nodes_spent

    def charge_pivots(self, k: int) -> None:
        self.pivots_spent += int(k)

    def charge_nodes(self, k: int) -> None:
        self.nodes_spent += int(k)

    def out_of_time(self) -> bool:
        return self.remaining_s() <= 0.0

    def exhausted(self) -> bool:
        return (self.out_of_time() or self.remaining_pivots() <= 0
                or self.remaining_nodes() <= 0)

    def lp_iter_cap(self, default: int, *, floor: int = 32,
                    granularity: int = 256) -> int:
        """Per-LP ``max_iters`` from the remaining pivot budget.

        Rounded up to ``granularity``, the reference's rule (its jitted
        twins take ``max_iters`` as a static argument), so budgets cut
        the same pivot counts in both packages; the numpy host loop
        additionally re-checks the exact budget every few pivots.
        """
        rem = self.remaining_pivots()
        if not np.isfinite(rem):
            return default
        cap = max(int(rem), floor)
        cap = -(-cap // granularity) * granularity
        return min(default, cap)

    def clamp_ilp_kwargs(self, kw: Optional[dict]) -> dict:
        """Bound an ``ilp_kwargs`` dict by the remaining budget."""
        kw = dict(kw or {})
        if self.deadline_s is not None:
            rem = max(self.remaining_s(), 0.0)
            kw["time_limit_s"] = min(kw.get("time_limit_s", rem), rem)
        if self.max_nodes is not None:
            rem_n = max(int(self.remaining_nodes()), 0)
            kw["max_nodes"] = min(kw.get("max_nodes", rem_n), rem_n)
        return kw


# -------------------------------------------------------------- monitor


@dataclasses.dataclass
class NumericalMonitor:
    """Numerical-health configuration + counters for one solve.

    One monitor is shared across every LP call of an ``engine.solve`` so
    the report can say "3 drift refactorizations, 41 Bland pivots" for
    the whole query, not per-LP.
    """
    drift_tol: float = DRIFT_TOL
    drift_check_every: int = DRIFT_CHECK_EVERY
    stall_refactor: int = STALL_REFACTOR
    stall_bland: int = STALL_BLAND
    # counters (mutated by the solver twins)
    drift_refactors: int = 0
    stall_refactors: int = 0
    stall_events: int = 0
    bland_pivots: int = 0
    max_resid: float = 0.0

    def record_resid(self, resid: float) -> bool:
        """Track a Binv residual; returns True when it demands a
        refactorization."""
        self.max_resid = max(self.max_resid, float(resid))
        if resid > self.drift_tol:
            self.drift_refactors += 1
            return True
        return False

    @property
    def events(self) -> int:
        return (self.drift_refactors + self.stall_refactors
                + self.stall_events)


# --------------------------------------------------------------- report


@dataclasses.dataclass
class SolveReport:
    """Structured outcome of one guarded solve (see module docstring for
    the status contract)."""
    status: str = OK
    budget: Optional[SolveBudget] = None
    monitor: Optional[NumericalMonitor] = None
    notes: List[str] = dataclasses.field(default_factory=list)
    fallbacks: List[str] = dataclasses.field(default_factory=list)
    degraded: bool = False
    lp_calls: int = 0
    lp_pivots: int = 0
    lp_truncated: int = 0     # LPs that hit an iteration/pivot/time cap
    lp_batches: int = 0       # batched dispatches (core.lp_batch flights)
    ilp_nodes: int = 0
    fault_retries: int = 0
    wall_s: float = 0.0
    warm_rejected: int = 0    # cascade warm-basis re-maps that fell cold
    # cross-query cache accounting (the reference's qcache; not ported yet)
    cache_hits: int = 0
    cache_misses: int = 0
    cache_pruned_lps: int = 0  # layer LPs skipped thanks to cached sets

    def note(self, msg: str) -> None:
        self.notes.append(str(msg))

    def rung(self, name: str, *, degrades: bool = False,
             detail: str = "") -> None:
        """Record a degradation-ladder rung.  ``degrades=True`` marks
        rungs that can cost solution quality (they flip the final status
        to DEGRADED even when a valid package comes back)."""
        self.fallbacks.append(name)
        self.degraded |= degrades
        self.note(f"fallback:{name}" + (f" ({detail})" if detail else ""))

    def absorb_lp(self, res) -> None:
        """Account one LPResult (any twin) into the report."""
        self.lp_calls += 1
        self.lp_pivots += int(getattr(res, "iters", 0))
        for n in getattr(res, "notes", ()) or ():
            self.note(n)
        # status codes: 0 OPTIMAL, 1 ITER_LIMIT, 2 INFEASIBLE, 3 BUDGET
        if getattr(res, "status", 0) in (1, 3):
            self.lp_truncated += 1

    def absorb_batch(self, results) -> None:
        """Account one ``solve_lp_batch`` flight (a sequence of
        LPResults solved as a single dispatch)."""
        self.lp_batches += 1
        for res in results:
            self.absorb_lp(res)

    def finalize(self, feasible: bool) -> "SolveReport":
        """Derive the final status from what happened (ERROR sticks)."""
        if self.budget is not None:
            self.wall_s = self.budget.elapsed_s
        if self.status == ERROR:
            return self
        if feasible:
            self.status = DEGRADED if self.degraded else OK
        elif self.budget is not None and self.budget.exhausted():
            self.status = BUDGET_EXHAUSTED
        else:
            self.status = INFEASIBLE
        return self

    def summary(self) -> str:
        b = self.budget
        spent = (f" pivots={b.pivots_spent} nodes={b.nodes_spent} "
                 f"wall={b.elapsed_s:.2f}s" if b is not None else "")
        fb = f" fallbacks={','.join(self.fallbacks)}" if self.fallbacks \
            else ""
        cache = (f" cache=hits:{self.cache_hits}/misses:{self.cache_misses}"
                 f" pruned_lps={self.cache_pruned_lps}"
                 if self.cache_hits or self.cache_misses else "")
        wr = f" warm_rejected={self.warm_rejected}" if self.warm_rejected \
            else ""
        return f"guard[{self.status}]{spent}{fb}{cache}{wr}"
