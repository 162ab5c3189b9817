"""PackageQueryEngine: the public API tying the pipeline together (port of
``repro.core.engine``).

    engine = PackageQueryEngine(table, attrs, d_f=100, alpha=100_000)
    engine.partition()                       # offline: build the hierarchy
    result = engine.solve(query)             # Progressive Shading
    result = engine.solve(query, lp_solver=solve_lp_kernel)  # device LPs
    base   = engine.solve_direct(query)      # black-box ILP (Gurobi stand-in)
    sr     = engine.solve_sketchrefine(query)

``table`` may be a dict of resident numpy columns or any
:class:`~repro_torch.core.relation.Relation` (e.g. ``MemmapRelation``
over an on-disk matrix).  Streamed relations run the whole pipeline
out-of-core: layer 0 is partitioned through the bucketing backend
(Appendix D.2, ``memory_rows`` bounding the resident set), the shading
cascade passes candidate-id subsets down, and Dual Reducer / validation
gather only the <= alpha candidate rows.  ``solve_direct``/``lp_bound``
assemble their full-relation form chunk-wise behind a size guard.

``device`` (default ``"cuda"``) is where the DLV build runs (each bucket's
DLV, for a streamed table) and where batched LP flights run (the batched
engine, ``core.lp_batch``: B&B waves with ``ilp_kwargs={"wave_width":
W}``); the engine raises at construction when CUDA is asked for and
absent.  The layer LPs run on the host numpy twin unless ``lp_solver=``
names the device twin (``repro_torch.core.lp_kernel.solve_lp_kernel``),
which then runs on the engine's device.

``cache=`` attaches the cross-query artifact cache (``core.qcache``):
``True`` makes a private ``QCache``, an instance is shared (across
engines and sessions: the serving shape), ``None`` or ``False`` means
none.  ``session(seed)`` gives a per-session engine over the same table,
hierarchy, cache and device with a private rng.

``mesh=`` (a ``torch.distributed.device_mesh.DeviceMesh``; every rank
builds the same engine) shards the build's stats passes over the mesh's
leading dim: layer 0's chunked group stats with ``chunk_rows``, and the
streaming passes of a streamed table.  Its device type must agree with
``device``.  The layer LPs reach the mesh through the solver::

    engine.solve(query, lp_solver=functools.partial(
        solve_lp, mesh=mesh, device=device))    # core.lp.solve_lp
"""
from __future__ import annotations

import copy
import functools
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import guard
from repro_torch.core import ilp as ilp_mod
from repro_torch.core.distributed import mesh_device
from repro_torch.core.dual_reducer import PackageResult
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.lp import OPTIMAL, solve_lp_np
from repro_torch.core.lp_kernel import solve_lp_kernel
from repro_torch.core.paql import PackageQuery
from repro_torch.core.qcache import QCache
from repro_torch.core.relation import Relation, as_relation, io_retry_count
from repro_torch.core.shading import progressive_shading
from repro_torch.core.sketchrefine import sketch_refine
from repro_torch.device import resolve_device


class PackageQueryEngine:
    def __init__(self, table, attrs: Sequence[str],
                 *, d_f: int = 100, alpha: int = 100_000,
                 seed: int = 0, partitioner_backend: str = "dlv",
                 layer0_backend: Optional[str] = None,
                 chunk_rows: Optional[int] = None,
                 memory_rows: Optional[int] = None, mesh=None,
                 cache=None, device="cuda"):
        if mesh is not None:
            mesh_device(mesh, device)
        self.table: Relation = as_relation(table, columns=list(attrs))
        self.attrs = list(attrs)
        self.d_f = d_f
        self.alpha = alpha
        self.partitioner_backend = partitioner_backend
        self.layer0_backend = layer0_backend
        self.chunk_rows = chunk_rows
        self.memory_rows = memory_rows
        self.mesh = mesh
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        self.hierarchy: Optional[Hierarchy] = None
        self.partition_time_s: float = 0.0
        # cross-query artifact cache: True -> a private QCache; or a QCache
        # instance shared across engines (the serving shape)
        if cache is True:
            cache = QCache()
        # identity test, not truthiness: an empty QCache has len() == 0
        self.cache = None if cache is None or cache is False else cache

    @property
    def n(self) -> int:
        return self.table.num_rows

    def session(self, seed: int = 0) -> "PackageQueryEngine":
        """A per-session engine sharing this engine's table, hierarchy,
        cross-query cache and device, with a PRIVATE rng.

        The serving shape: one resident engine (partitioned once) serves
        many concurrent sessions.  ``engine.rng`` is the only unshareable
        state (a numpy Generator is not thread-safe and its draw order must
        stay per-session deterministic); the Relation, Hierarchy and QCache
        are read-only after partition or thread-safe.
        """
        s = copy.copy(self)
        s.rng = np.random.default_rng(seed)
        return s

    def partition(self) -> "PackageQueryEngine":
        t0 = time.time()
        self.hierarchy = Hierarchy(self.table, self.attrs, d_f=self.d_f,
                                   alpha=self.alpha, rng=self.rng,
                                   backend=self.partitioner_backend,
                                   layer0_backend=self.layer0_backend,
                                   chunk_rows=self.chunk_rows,
                                   memory_rows=self.memory_rows,
                                   mesh=self.mesh, device=self.device)
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
        ``lp_solver=solve_lp_kernel`` runs on the engine's ``device``, as
        do the batched LP flights (B&B waves, Dual Reducer rungs).

        With a ``cache``, solves consult the cross-query cache before
        descending and populate it after clean solves; hit/miss/prune
        counters land on ``res.report``."""
        if self.hierarchy is None:
            self.partition()
        if self.cache is not None:
            self.cache.register(self.hierarchy)
        if ps_kwargs.get("lp_solver") is solve_lp_kernel:
            ps_kwargs["lp_solver"] = functools.partial(solve_lp_kernel,
                                                       device=self.device)
        t0 = time.time()
        report = guard.SolveReport(budget=budget or guard.SolveBudget(),
                                   monitor=guard.NumericalMonitor())
        report.budget.start()
        io0 = io_retry_count()
        try:
            res = progressive_shading(self.hierarchy, query, self.table,
                                      alpha=self.alpha, dr_q=dr_q,
                                      rng=self.rng, ilp_kwargs=ilp_kwargs,
                                      budget=report.budget, report=report,
                                      ladder=guarded, qcache=self.cache,
                                      device=self.device, **ps_kwargs)
        # repro: allow[REPRO004] guard contract: guarded solve must never
        # raise -- contain, report, and return an empty (infeasible) result
        except Exception as e:
            if not guarded:
                raise
            report.status = guard.ERROR
            report.note(f"error: {type(e).__name__}: {e}")
            res = PackageResult(False, np.zeros(0, np.int64), np.zeros(0),
                                0.0, 0.0, status="error")
        report.fault_retries = io_retry_count() - io0
        res.report = report.finalize(res.feasible)
        res.status += f" t={time.time() - t0:.3f}s"
        return res

    def solve_direct(self, query: PackageQuery,
                     ilp_kwargs: Optional[dict] = None) -> PackageResult:
        """Black-box ILP over the full relation (the Gurobi role).  The
        standard form streams chunk-wise off a Relation; a size guard
        raises for relations too large to hold densely."""
        c, A, bl, bu, ub = query.matrices(self.table, None)
        res = ilp_mod.solve_ilp(c, A, bl, bu, ub,
                                **{"device": self.device,
                                   **(ilp_kwargs or {})})
        if not res.feasible:
            return PackageResult(False, np.zeros(0, np.int64), np.zeros(0),
                                 0.0, 0.0, status="ilp_infeasible")
        nz = res.x > 0.5
        obj = -res.obj if query.maximize else res.obj
        lp_obj = -res.lp_obj if query.maximize else res.lp_obj
        return PackageResult(True, np.flatnonzero(nz), res.x[nz], obj,
                             lp_obj, status="ok")

    def solve_sketchrefine(self, query: PackageQuery,
                           tau_frac: float = 0.001,
                           ilp_kwargs: Optional[dict] = None) -> PackageResult:
        """The SketchRefine baseline (``core.sketchrefine``) over this
        engine's table; a DLV or bucketed partition runs on the engine's
        device."""
        return sketch_refine(query, self.table, self.attrs,
                             tau_frac=tau_frac, ilp_kwargs=ilp_kwargs,
                             memory_rows=self.memory_rows,
                             chunk_rows=self.chunk_rows, device=self.device)

    def lp_bound(self, query: PackageQuery) -> float:
        """LP relaxation over the full relation (integrality-gap metric).
        Streams its matrix assembly like solve_direct (same size guard)."""
        c, A, bl, bu, ub = query.matrices(self.table, None)
        res = solve_lp_np(c, A, bl, bu, ub, max_iters=20000)
        if res.status != OPTIMAL:
            return np.nan
        return -res.obj if query.maximize else res.obj
