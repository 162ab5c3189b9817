"""Shading + Progressive Shading — paper §2, Algorithms 1 and 2.

Each Shading step solves the LP relaxation over the current candidate set at
layer l (Parallel Dual Simplex), keeps the support, and expands/augments via
Neighbor Sampling down to layer l-1.  At layer 0, Dual Reducer produces the
final package.

Warm starts down the cascade (App. C customization): consecutive layer LPs
share the m slack columns and their structural columns are related by the
parent/child group structure, so layer l's final basis is re-mapped onto
layer l-1's candidate set by ``map_warm_basis`` — each basic group maps to
its surviving child representative closest in objective value, slacks map
index-shifted, and every other (new) column enters nonbasic at the bound
matching the sign of its reduced cost, which keeps the start dual-feasible
(core.lp warm-start contract).  The engine validates the mapped basis and
silently falls back to a cold start when it is singular, so warm starting
can only change iteration counts, never answers.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np

from repro_torch.core.dual_reducer import PackageResult, dual_reducer
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.lp import (INFEASIBLE, OPTIMAL, LPResult, WarmStart,
                           fill_warm_basis, solve_lp_np)
from repro_torch.core.lp_batch import solve_lp_batch
from repro_torch.core.neighbor import neighbor_sampling
from repro_torch.core.paql import PackageQuery
from repro_torch.core.relation import gather_column

FALLBACK_SEED = 64   # LP-infeasible layer: seed with top-k by objective


def _expand_warm(res: LPResult, pos: np.ndarray, n_old: int,
                 n_new: int) -> WarmStart:
    """Re-index an LP state over n_old columns onto a superset LP with
    n_new columns; ``pos[j]`` is old column j's position in the new set
    (slacks shift by the new n).  Used by the batched ladder to carry
    the failed layer LP's basis into the union candidate set."""
    m = len(res.y)
    basis = np.asarray(res.basis, np.int64)
    struct = basis < n_old
    safe = np.minimum(basis, n_old - 1)
    new_basis = np.where(struct, pos[safe], n_new + (basis - n_old))
    at_upper = np.zeros(n_new + m, bool)
    at_upper[pos] = res.at_upper[:n_old]
    at_upper[n_new:] = res.at_upper[n_old:]
    return WarmStart(new_basis.astype(np.int64), at_upper)


def map_warm_basis(hier: Hierarchy, l: int, S_l: np.ndarray,
                   res: Optional[LPResult], S_next: np.ndarray,
                   obj_attr: Optional[str] = None) -> Optional[WarmStart]:
    """Re-map layer-l LP basis/bound state onto the layer-(l-1) LP.

    Column j of the layer-l LP is group ``S_l[j]``; column i of the next LP
    is the layer-(l-1) representative ``S_next[i]`` whose parent group is
    ``hier.layers[l].part.gid[S_next[i]]``.  Basic groups map to their
    child in S_next with the closest objective value (the group rep is the
    member mean, so the closest child is the best stand-in for the basic
    column); slacks shift by the new n.  Unmappable basic columns are
    replaced by unused slacks — the engine's validation rejects the basis
    if that ever makes it singular.
    """
    if res is None:
        return None
    part = hier.layers[l].part
    if part is None:
        return None
    n_prev, n_next = len(S_l), len(S_next)
    m = len(res.y)
    S_next = np.asarray(S_next, np.int64)
    parent = part.gid[S_next]                    # parent group per candidate
    order = np.argsort(parent, kind="stable")
    parent_sorted = parent[order]

    attr = obj_attr if obj_attr in hier.attrs else hier.attrs[0]
    # candidate-only gathers: layer l-1 may be a streamed layer-0 relation,
    # so only the S_next rows are ever materialised
    obj_next_S = gather_column(hier.layers[l - 1].table, attr, S_next)
    obj_prev = np.asarray(hier.layers[l].table[attr], np.float64)

    new_basis = np.full(m, -1, np.int64)
    for k, j in enumerate(np.asarray(res.basis, np.int64)):
        if j >= n_prev:                          # slack i -> slack i
            new_basis[k] = n_next + (j - n_prev)
            continue
        g = int(S_l[j])
        lo = np.searchsorted(parent_sorted, g, side="left")
        hi = np.searchsorted(parent_sorted, g, side="right")
        if hi > lo:                              # children present in S_next
            cand = order[lo:hi]
            new_basis[k] = int(cand[np.argmin(
                np.abs(obj_next_S[cand] - obj_prev[g]))])
    new_basis = fill_warm_basis(new_basis, n_next, m)
    if new_basis is None:
        return None
    # bound-side hint: children inherit their parent group's side
    au_prev = np.zeros(hier.layers[l].size, bool)
    au_prev[np.asarray(S_l, np.int64)] = res.at_upper[:n_prev]
    at_upper = np.concatenate([au_prev[parent], res.at_upper[n_prev:]])
    return WarmStart(new_basis, at_upper)


def shading(hier: Hierarchy, l: int, alpha: int, S_l: np.ndarray,
            query: PackageQuery, *, max_lp_iters: int = 20000,
            layer_solver: str = "lp", sampler: str = "neighbor",
            rng: Optional[np.random.Generator] = None,
            warm_start=None, return_state: bool = False,
            lp_solver=None, budget=None, report=None, widen=None,
            ladder: bool = True, skip_lp: bool = False, device="cuda"):
    """One Shading step (Algorithm 2): layer-l candidates -> layer-(l-1).

    Ablation knobs (paper Mini-Experiments 1 and 2):
      layer_solver: 'lp' (paper's choice) | 'ilp' (replace line 2 with an
        ILP — shown not to help);
      sampler: 'neighbor' (Algorithm 3) | 'random' (random representative
        sampling — shown much worse).
    warm_start: optional basis for the layer LP (see map_warm_basis);
    return_state: also return ``(S_next, res, S_used, s_prime)`` — the
      layer LPResult (None for the ilp ablation), the candidate set the
      LP actually solved over (α escalation can widen it, and the basis
      indices only make sense against it), and the surviving support —
      so progressive_shading can warm-start the next layer and widen on
      failure.
    lp_solver: solve_lp_np-compatible callable for the layer LP (default
      the numpy twin; ``core.lp_kernel.solve_lp_kernel`` runs the layer
      LPs on the device through the pricing and BFRT kernels).

    Guard integration (``budget``/``report``: guard objects threaded from
    the engine).  With ``ladder=True`` a failed layer LP degrades in
    order instead of silently seeding: (1) warm retry at relaxed
    tolerance, (2) re-solve over a widened candidate set (``widen(2)``,
    α escalation — the paper's premature-discard remedy), (3) the
    top-objective seed fallback below, each recorded as a rung.
    ``skip_lp=True`` (budget exhausted upstream) bypasses the layer LP
    entirely and descends via the seed path.  ``device`` is where a
    batched flight would run (the two-lane ladder flight runs on the
    host, as ``backend="auto"`` sends K <= 2 there).
    """
    lp_solver = lp_solver or solve_lp_np
    monitor = report.monitor if report is not None else None
    layer_table = hier.layers[l].table
    S_used = np.asarray(S_l)
    res: Optional[LPResult] = None

    def _lp(S_cols, warm, solver=None, **extra):
        c, A, bl, bu, ub = query.matrices(layer_table, S_cols)
        kw = dict(extra)
        if budget is not None:
            kw["budget"] = budget
        if monitor is not None:
            kw["monitor"] = monitor
        return (solver or lp_solver)(c, A, bl, bu, ub,
                                     max_iters=max_lp_iters,
                                     warm_start=warm, **kw)

    if skip_lp:
        s_prime = np.zeros(0, np.int64)
    elif layer_solver == "ilp":
        from repro_torch.core.ilp import solve_ilp
        c, A, bl, bu, ub = query.matrices(layer_table, S_used)
        res_i = solve_ilp(c, A, bl, bu, ub, max_nodes=100, time_limit_s=10,
                          budget=budget, monitor=monitor, device=device)
        s_prime = S_used[res_i.x > 1e-9] if res_i.feasible \
            else np.zeros(0, np.int64)
    else:
        res = _lp(S_used, warm_start)
        if report is not None:
            report.absorb_lp(res)
        if res.status != OPTIMAL and ladder:
            retry_wanted = res.status == INFEASIBLE
            # evaluate the widened set up front (neighbor_sampling is
            # deterministic) so both ladder rungs can ride one batched
            # dispatch when they are both in play
            S_wide = None
            if widen is not None and not (budget is not None
                                          and budget.exhausted()):
                S_w = np.asarray(widen(2))
                if len(S_w) > len(S_used):
                    S_wide = S_w
            if retry_wanted and S_wide is not None \
                    and lp_solver is solve_lp_np:
                # both rungs needed: solve them as ONE batched flight of
                # bound-variants over the union candidate set U — the
                # relax-tol retry lane masks non-S_used columns out via
                # ub = 0 (warm from the failed LP's basis, tol 1e-5),
                # the α-escalation lane runs the full U cold.  A
                # degraded rung costs one dispatch, not three solves.
                U = np.union1d(np.asarray(S_used, np.int64),
                               np.asarray(S_wide, np.int64))
                cU, AU, blU, buU, ubU = query.matrices(layer_table, U)
                pos = np.searchsorted(U, np.asarray(S_used, np.int64))
                ub_mask = np.zeros(len(U))
                ub_mask[pos] = ubU[pos]
                lanes = solve_lp_batch(
                    cU, AU, blU, buU, [ub_mask, ubU],
                    tol=[1e-5, 1e-7],
                    warm_starts=[_expand_warm(res, pos, len(S_used),
                                              len(U)), None],
                    max_iters=max_lp_iters, budget=budget,
                    monitor=monitor, device=device)
                retry, wide_res = lanes
                if report is not None:
                    report.lp_batches += 1
                    report.rung("layer_relax_tol",
                                detail=f"layer {l}: retry "
                                       f"status={retry.status}")
                    report.absorb_lp(retry)
                if retry.status == OPTIMAL:
                    res = retry
                    S_used = U
                else:
                    if report is not None:
                        report.rung("alpha_escalation",
                                    detail=f"layer {l}: |S| "
                                           f"{len(S_used)} -> "
                                           f"{len(U)}")
                        report.absorb_lp(wide_res)
                    if wide_res.status == OPTIMAL:
                        res = wide_res
                        S_used = U
            else:
                if retry_wanted:
                    # ladder rung 1: warm retry at relaxed tolerance
                    # (numpy twin — the only one with a tol knob)
                    retry = _lp(S_used, res, solver=solve_lp_np, tol=1e-5)
                    if report is not None:
                        report.rung("layer_relax_tol",
                                    detail=f"layer {l}: retry "
                                           f"status={retry.status}")
                        report.absorb_lp(retry)
                    if retry.status == OPTIMAL:
                        res = retry
                if res.status != OPTIMAL and S_wide is not None and not (
                        budget is not None and budget.exhausted()):
                    # ladder rung 2: α escalation — re-solve over a
                    # doubled candidate set (cold: the basis indices
                    # don't transfer)
                    wide_res = _lp(S_wide, None)
                    if report is not None:
                        report.rung("alpha_escalation",
                                    detail=f"layer {l}: |S| "
                                           f"{len(S_used)} -> "
                                           f"{len(S_wide)}")
                        report.absorb_lp(wide_res)
                    if wide_res.status == OPTIMAL:
                        res = wide_res
                        S_used = S_wide
        s_prime = S_used[res.x > 1e-9] if res.status == OPTIMAL \
            else np.zeros(0, np.int64)
    if len(s_prime) == 0:
        # representative-level solve infeasible: seed augmentation with the
        # best-objective representatives so it can still recover
        if report is not None and not skip_lp:
            report.rung("layer_seed_fallback", detail=f"layer {l}")
        obj = layer_table[query.objective_attr][S_used]
        order = np.argsort(-obj if query.maximize else obj, kind="stable")
        s_prime = S_used[order[:FALLBACK_SEED]]

    if sampler == "random":
        rng = rng or np.random.default_rng(0)
        # one vectorized gather for the support's members (batch GetTuples)
        members = [hier.get_tuples_batch(l - 1, np.asarray(s_prime,
                                                           np.int64))]
        seen = set(int(g) for g in s_prime)
        count = sum(len(m) for m in members)
        n_l = hier.layers[l].size
        while count < alpha and len(seen) < n_l:
            g = int(rng.integers(0, n_l))
            if g in seen:
                continue
            seen.add(g)
            m = hier.get_tuples(l - 1, g)
            members.append(m)
            count += len(m)
        cand = np.unique(np.concatenate(members))
        S_next = cand[:alpha]
    else:
        S_next = neighbor_sampling(hier, l, alpha, s_prime,
                                   query.objective_attr, query.maximize)
    if return_state:
        return S_next, res, S_used, s_prime
    return S_next


@dataclasses.dataclass
class PSStats:
    """Cascade-level observability for one progressive_shading call
    (attached to the returned ``PackageResult.ps_stats``)."""
    layer_sizes: list = dataclasses.field(default_factory=list)
    lp_iters: int = 0
    time_s: float = 0.0
    # warm starts that silently fell cold: map_warm_basis re-maps that
    # came back None, plus engine-side basis validations that rejected
    # ("warm_start_rejected" LP notes)
    warm_rejected: int = 0
    cache: str = ""          # "" | "package" | "exact" | "contained"


def _count_warm_rejects(lp_res, stats: PSStats, report) -> None:
    """Surface engine-side warm-start rejections (lp._warm_state notes)."""
    for note in getattr(lp_res, "notes", ()) or ():
        if "warm_start_rejected" in note:
            stats.warm_rejected += 1
            if report is not None:
                report.warm_rejected += 1


def _solve_from_cache(hier, query, table, hit, qcache, *, dr_q,
                      ilp_kwargs, dr_aux, budget, report,
                      stats: PSStats, device) -> Optional[PackageResult]:
    """Serve a cache hit, or return None to fall back to the cold descent.

    Exact hits with a stored package take the validated fast path:
    ``check_package`` against the relation plus an objective re-compute.
    Every other hit shortcuts to Dual Reducer over the cached layer-0
    candidate set (the pre-prune), warm-started from the cached lp1
    basis, its flights on ``device``; the resulting LP bound must
    reproduce the cached bound (exact hits) or respect containment
    monotonicity (contained hits), else the hit is abandoned.  A private
    rng keeps the engine rng untouched so an abandoned hit leaves the
    cold descent bit-identical to an uncached solve.
    """
    entry = hit.entry
    tol = 1e-6 * max(1.0, abs(entry.lp_bound))
    if hit.exact and qcache.reuse_packages and entry.package_idx is not None:
        idx, mult = entry.package_idx, entry.package_mult
        if query.check_package(table, idx, mult):
            obj = query.objective_value(table, idx, mult)
            if abs(obj - entry.package_obj) <= \
                    1e-6 * max(1.0, abs(entry.package_obj)):
                if report is not None:
                    report.cache_pruned_lps += hier.L + 1
                stats.cache = "package"
                return PackageResult(True, idx.copy(), mult.copy(), obj,
                                     entry.lp_bound,
                                     status="ok cached=package")
        return None
    S0 = entry.candidates(1)
    if S0 is None or len(S0) == 0:
        return None
    warm = hit.warm_for_layer0(hier, query, S0)
    res = dual_reducer(query, table, S0, q=dr_q,
                       rng=np.random.default_rng(0),
                       ilp_kwargs=ilp_kwargs, aux=dr_aux, warm_start=warm,
                       budget=budget, report=report, ladder=False,
                       device=device)
    if not res.feasible or res.status != "ok":
        return None
    if hit.exact:
        ok = abs(res.lp_obj - entry.lp_bound) <= tol
    else:
        # containment monotonicity: the tightened query's bound cannot
        # beat the cached (looser) query's bound
        ok = res.lp_obj <= entry.lp_bound + tol if query.maximize \
            else res.lp_obj >= entry.lp_bound - tol
        # quality gate: a pruned solve far off its own LP bound means
        # the cached candidate set lost support this query needed
        gap = (res.lp_obj - res.obj) if query.maximize \
            else (res.obj - res.lp_obj)
        ok &= gap <= qcache.gap_accept * max(1.0, abs(res.lp_obj))
    if not ok:
        return None
    if report is not None:
        report.cache_pruned_lps += hier.L
    stats.cache = hit.kind
    res.status = f"ok cached={hit.kind}"
    return res


def progressive_shading(hier: Hierarchy, query: PackageQuery,
                        table, *,
                        alpha: Optional[int] = None,
                        dr_q: int = 500,
                        rng: Optional[np.random.Generator] = None,
                        ilp_kwargs: Optional[dict] = None,
                        layer_solver: str = "lp",
                        sampler: str = "neighbor",
                        dr_aux: str = "lp",
                        warm_starts: bool = True,
                        lp_solver=None,
                        budget=None, report=None,
                        ladder: bool = True,
                        qcache=None,
                        device="cuda") -> PackageResult:
    """Algorithm 1: iterate Shading from layer L to 0, then Dual Reducer.

    Each layer's LP is warm-started from the previous layer's final basis
    (``warm_starts=False`` restores all-cold solves); the layer-1 basis
    is likewise re-mapped onto the layer-0 candidate set to warm-start
    Dual Reducer's first LP.  ``lp_solver`` routes every layer LP through
    an alternate solve_lp_np-compatible engine (e.g. the device twin
    ``core.lp_kernel.solve_lp_kernel``).

    Guard integration: one ``budget`` bounds the whole cascade; once it
    is exhausted the remaining layer LPs are skipped (``budget_descend``
    rung).  If Dual Reducer fails and budget remains, the layer-0
    candidate set is rebuilt at double α from the layer-1 support and
    Dual Reducer retried (``dr_alpha_escalation``).  ``device`` (default
    ``"cuda"``) is where batched LP flights run (the Dual Reducer's rungs,
    B&B waves).

    Cross-query cache (``qcache``: a :class:`repro_torch.core.qcache.
    QCache`): consult-before-descend -- a hit serves a validated cached
    package (exact) or shortcuts to Dual Reducer over the cached layer-0
    candidate set (exact/contained); a hit that fails validation records
    a ``cache_fallback`` rung and descends cold, consulting cached
    per-layer bases where the candidate sets still match exactly.
    Populate-after-solve -- a clean, non-degraded cold solve stores its
    per-layer candidate sets, LP bases and final package.
    """
    t0 = time.time()
    alpha = alpha or hier.alpha
    stats = PSStats()
    fp = sig = hit = None
    owner = False
    if qcache is not None:
        fp = qcache.register(hier)
        sig = query.signature()
        # Consult loop (at most two probes): a miss claims the populate
        # for this key; if another session already owns the same cold
        # solve, wait for it and re-probe -- the waiter then usually
        # takes the freshly stored entry as a hit instead of running a
        # duplicate descent.  Single-threaded this is exactly one probe
        # and an immediate claim.
        for _attempt in (0, 1):
            hit = qcache.lookup(fp, sig)
            if report is not None:
                if hit is not None:
                    report.cache_hits += 1
                else:
                    report.cache_misses += 1
            if hit is not None:
                res = _solve_from_cache(hier, query, table, hit, qcache,
                                        dr_q=dr_q, ilp_kwargs=ilp_kwargs,
                                        dr_aux=dr_aux, budget=budget,
                                        report=report, stats=stats,
                                        device=device)
                if res is not None:
                    stats.time_s = time.time() - t0
                    res.ps_stats = stats
                    return res
                qcache.note_fallback()
                if report is not None:
                    report.rung("cache_fallback",
                                detail=f"{hit.kind} hit abandoned")
                break
            if qcache.begin_populate(fp, sig):
                owner = True
                break
            qcache.wait_populate(fp, sig)
    try:
        entry = hit.entry if hit is not None else None
        S = np.arange(hier.layers[hier.L].size)
        sizes = [len(S)]
        warm = None
        support = None      # previous layer's surviving support (widening)
        art_cands: Dict[int, np.ndarray] = {}
        art_layers: Dict[int, tuple] = {}
        for l in range(hier.L, 0, -1):
            skip = budget is not None and budget.start().exhausted()
            if skip and report is not None:
                report.rung("budget_descend", degrades=True,
                            detail=f"layer {l}: LP skipped")
            widen = None
            if l < hier.L and support is not None and len(support):
                widen = (lambda f, _s=support, _l=l + 1:
                         neighbor_sampling(hier, _l, f * alpha, _s,
                                           query.objective_attr,
                                           query.maximize))
            if warm is None and warm_starts and entry is not None:
                # consult-before-descend: the abandoned hit's same-layer
                # basis still warm-starts this LP when the candidate
                # columns match exactly (warm starts never change answers)
                state = entry.layer_warms.get(l)
                if state is not None and np.array_equal(
                        np.asarray(state[0]), np.asarray(S)):
                    warm = WarmStart(state[1].copy(), state[2].copy())
            S_next, lp_res, S_used, support = shading(
                hier, l, alpha, S, query, layer_solver=layer_solver,
                sampler=sampler, rng=rng, warm_start=warm,
                return_state=True, lp_solver=lp_solver, budget=budget,
                report=report, widen=widen, ladder=ladder, skip_lp=skip,
                device=device)
            if lp_res is not None:
                stats.lp_iters += int(lp_res.iters)
                _count_warm_rejects(lp_res, stats, report)
                if lp_res.status == OPTIMAL:
                    art_layers[l] = (S_used, lp_res.basis, lp_res.at_upper,
                                     lp_res.obj)
            art_cands[l] = S_next
            warm = map_warm_basis(hier, l, S_used, lp_res, S_next,
                                  obj_attr=query.objective_attr) \
                if warm_starts else None
            if warm_starts and lp_res is not None \
                    and lp_res.status == OPTIMAL and warm is None:
                stats.warm_rejected += 1
                if report is not None:
                    report.warm_rejected += 1
                    report.note(f"warm_map_rejected: layer {l}")
            S = S_next
            sizes.append(len(S))
        if warm is None and warm_starts and entry is not None \
                and entry.dr_warm is not None:
            S0c = entry.candidates(1)
            if S0c is not None and np.array_equal(S0c, np.asarray(S)):
                warm = entry.dr_warm_start()
        res = dual_reducer(query, table, S, q=dr_q, rng=rng,
                           ilp_kwargs=ilp_kwargs, aux=dr_aux,
                           warm_start=warm, budget=budget, report=report,
                           ladder=ladder, device=device)
        if not res.feasible and ladder and support is not None \
                and len(support) and not (budget is not None
                                          and budget.exhausted()):
            # α escalation at layer 0: rebuild the candidate set at double
            # width from the layer-1 support and retry Dual Reducer cold
            S_wide = neighbor_sampling(hier, 1, 2 * alpha, support,
                                       query.objective_attr, query.maximize)
            if len(S_wide) > len(S):
                if report is not None:
                    report.rung("dr_alpha_escalation",
                                detail=f"|S| {len(S)} -> {len(S_wide)}")
                res2 = dual_reducer(query, table, S_wide, q=dr_q, rng=rng,
                                    ilp_kwargs=ilp_kwargs, aux=dr_aux,
                                    budget=budget, report=report,
                                    ladder=ladder, device=device)
                if res2.feasible:
                    res = res2
                    sizes[-1] = len(S_wide)
                    art_cands[1] = S_wide
        if qcache is not None and res.feasible and res.status == "ok" \
                and (report is None or not report.degraded):
            # populate-after-solve: only clean, full-quality solves seed
            # the cache (degraded/truncated artifacts would poison reuse)
            qcache.store(fp, sig, hier=hier, cands=art_cands,
                         layer_warms=art_layers, dr_warm=res.lp_warm,
                         lp_bound=res.lp_obj,
                         package=(res.idx, res.mult, res.obj))
        res.status += f" layers={sizes}"
        stats.layer_sizes = sizes
        stats.time_s = time.time() - t0
        res.ps_stats = stats
        return res
    finally:
        # release the populate claim whether or not the solve stored
        # (waiters re-probe; a failed solve hands the key to the next
        # session)
        if owner:
            qcache.end_populate(fp, sig)
