"""PackageQueryEngine: the public API tying the pipeline together (port of
``repro.core.engine`` for in-memory tables).

    engine = PackageQueryEngine(table, attrs, d_f=100, alpha=100_000)
    engine.partition()                       # offline: build the hierarchy
    result = engine.solve(query)             # Progressive Shading
    result = engine.solve(query, lp_solver=solve_lp_kernel)  # device LPs
    base   = engine.solve_direct(query)      # black-box ILP (Gurobi stand-in)

``device`` (default ``"cuda"``) is where the DLV build runs; the engine
raises at construction when CUDA is asked for and absent.  The layer LPs
run on the host numpy twin unless ``lp_solver=`` names the device twin
(``repro_torch.core.lp_kernel.solve_lp_kernel``), which then runs on the
engine's device.  SketchRefine, the cross-query cache and streamed
relations are later work.
"""
from __future__ import annotations

import functools
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import guard
from repro_torch.core import ilp as ilp_mod
from repro_torch.core.dual_reducer import PackageResult
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.lp import OPTIMAL, solve_lp_np
from repro_torch.core.lp_kernel import solve_lp_kernel
from repro_torch.core.paql import PackageQuery
from repro_torch.core.relation import Relation, as_relation
from repro_torch.core.shading import progressive_shading
from repro_torch.device import resolve_device


class PackageQueryEngine:
    def __init__(self, table, attrs: Sequence[str],
                 *, d_f: int = 100, alpha: int = 100_000,
                 seed: int = 0, partitioner_backend: str = "dlv",
                 device="cuda"):
        self.table: Relation = as_relation(table, columns=list(attrs))
        self.attrs = list(attrs)
        self.d_f = d_f
        self.alpha = alpha
        self.partitioner_backend = partitioner_backend
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        self.hierarchy: Optional[Hierarchy] = None
        self.partition_time_s: float = 0.0

    @property
    def n(self) -> int:
        return self.table.num_rows

    def partition(self) -> "PackageQueryEngine":
        t0 = time.time()
        self.hierarchy = Hierarchy(self.table, self.attrs, d_f=self.d_f,
                                   alpha=self.alpha, rng=self.rng,
                                   backend=self.partitioner_backend,
                                   device=self.device)
        self.partition_time_s = time.time() - t0
        return self

    # ------------------------------------------------------------ solvers
    def solve(self, query: PackageQuery, *, dr_q: int = 500,
              ilp_kwargs: Optional[dict] = None,
              budget: Optional[guard.SolveBudget] = None,
              guarded: bool = True,
              **ps_kwargs) -> PackageResult:
        """Progressive Shading (the paper's algorithm).  Extra kwargs go to
        ``progressive_shading`` (``lp_solver``, ``layer_solver``,
        ``sampler``, ``dr_aux``, ``warm_starts``).

        Guarded by default: every call returns a PackageResult carrying a
        ``guard.SolveReport`` (``res.report``) with a defined status and
        never raises; ``budget=`` bounds the whole cascade end to end.
        ``guarded=False`` disables the degradation ladder and re-raises.
        ``lp_solver=solve_lp_kernel`` runs on the engine's ``device``."""
        if self.hierarchy is None:
            self.partition()
        if ps_kwargs.get("lp_solver") is solve_lp_kernel:
            ps_kwargs["lp_solver"] = functools.partial(solve_lp_kernel,
                                                       device=self.device)
        t0 = time.time()
        report = guard.SolveReport(budget=budget or guard.SolveBudget(),
                                   monitor=guard.NumericalMonitor())
        report.budget.start()
        try:
            res = progressive_shading(self.hierarchy, query, self.table,
                                      alpha=self.alpha, dr_q=dr_q,
                                      rng=self.rng, ilp_kwargs=ilp_kwargs,
                                      budget=report.budget, report=report,
                                      ladder=guarded, **ps_kwargs)
        # guard contract: a guarded solve never raises -- contain, report
        # and return an empty (infeasible) result
        except Exception as e:
            if not guarded:
                raise
            report.status = guard.ERROR
            report.note(f"error: {type(e).__name__}: {e}")
            res = PackageResult(False, np.zeros(0, np.int64), np.zeros(0),
                                0.0, 0.0, status="error")
        res.report = report.finalize(res.feasible)
        res.status += f" t={time.time() - t0:.3f}s"
        return res

    def solve_direct(self, query: PackageQuery,
                     ilp_kwargs: Optional[dict] = None) -> PackageResult:
        """Black-box ILP over the full relation (the Gurobi role)."""
        c, A, bl, bu, ub = query.matrices(self.table, None)
        res = ilp_mod.solve_ilp(c, A, bl, bu, ub, **(ilp_kwargs or {}))
        if not res.feasible:
            return PackageResult(False, np.zeros(0, np.int64), np.zeros(0),
                                 0.0, 0.0, status="ilp_infeasible")
        nz = res.x > 0.5
        obj = -res.obj if query.maximize else res.obj
        lp_obj = -res.lp_obj if query.maximize else res.lp_obj
        return PackageResult(True, np.flatnonzero(nz), res.x[nz], obj,
                             lp_obj, status="ok")

    def lp_bound(self, query: PackageQuery) -> float:
        """LP relaxation over the full relation (integrality-gap metric)."""
        c, A, bl, bu, ub = query.matrices(self.table, None)
        res = solve_lp_np(c, A, bl, bu, ub, max_iters=20000)
        if res.status != OPTIMAL:
            return np.nan
        return -res.obj if query.maximize else res.obj
