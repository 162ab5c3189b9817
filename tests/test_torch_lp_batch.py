"""The port's batched bound-variant LP engine against the JAX reference,
on the CPU (the kernel's plain version, ``device="cpu"``).

Every lane of every flight is held to the reference's numpy twin
``repro.core.lp.solve_lp_np`` and to the reference's batched engine
``repro.core.lp_batch.solve_lp_batch(backend="jax")`` on the same inputs,
made from a numpy seed.  The bar is the reference's own
(``tests/test_lp_batch.py::_assert_lane_parity``): equal status; on an
optimal lane equal iterations, sorted basis and bound pattern, objective
and x within 1e-9 (absolute).  Under a shared pivot budget per-lane
status, iterations and notes must be equal (exact).
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import torch_dist_worker as W
from repro.core import guard as ref_guard
from repro.core import lp as ref_lp
from repro.core import lp_batch as ref_batch
from repro.core.ilp import solve_ilp as ref_ilp
from repro_torch.core import guard
from repro_torch.core import lp as port_lp
from repro_torch.core.ilp import ILP_LIMIT, ILP_OPTIMAL, solve_ilp
from repro_torch.core.lp import (BUDGET, INFEASIBLE, OPTIMAL, WarmStart,
                                 solve_lp_np, verify_optimality)
from repro_torch.core.lp_batch import (batch_cache_stats, batch_stats,
                                       solve_lp_batch)
from repro_torch.kernels.lp_batch import lockstep_trips


def batch(*a, **kw):
    """The port's batched engine on the CPU (its plain version)."""
    return solve_lp_batch(*a, backend="device", device="cpu", **kw)


def ref_jax(*a, **kw):
    return ref_batch.solve_lp_batch(*a, backend="jax", **kw)


def _flight(seed, K=5, n=24, m=3):
    """The reference test's flight: one shared (c, A, bl, bu) plus K
    feasible bound-variants."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    ub = rng.integers(1, 4, size=n).astype(float)
    x0 = rng.uniform(0, 1, n) * ub
    act = A @ x0
    width = np.abs(rng.normal(size=m)) * 2 + 0.5
    bl = act - width
    bu = act + width
    ubs = [ub * rng.uniform(0.5, 1.0, n) for _ in range(K)]
    lbs = [np.zeros(n) for _ in range(K)]
    return c, A, bl, bu, ubs, lbs


def _lane(res, ref, lane=""):
    assert res.status == ref.status, lane
    if ref.status == OPTIMAL:
        assert res.obj == pytest.approx(ref.obj, abs=1e-9), lane
        assert res.iters == ref.iters, lane
        assert np.array_equal(np.sort(res.basis), np.sort(ref.basis)), lane
        assert np.array_equal(res.at_upper, ref.at_upper), lane
        np.testing.assert_allclose(res.x, ref.x, atol=1e-9, err_msg=lane)


def _held(ress, refs_np, refs_jax):
    assert len(ress) == len(refs_np) == len(refs_jax)
    for k, (r, a, b) in enumerate(zip(ress, refs_np, refs_jax)):
        _lane(r, a, f"lane {k} vs solve_lp_np")
        _lane(r, b, f"lane {k} vs the reference's batched engine")


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_batched_matches_sequential_cold(seed):
    c, A, bl, bu, ubs, lbs = _flight(seed)
    ress = batch(c, A, bl, bu, ubs, lbs)
    _held(ress, [ref_lp.solve_lp_np(c, A, bl, bu, u, lb=l)
                 for u, l in zip(ubs, lbs)], ref_jax(c, A, bl, bu, ubs, lbs))
    for r, u, l in zip(ress, ubs, lbs):
        if r.status == OPTIMAL:
            ok, msg = verify_optimality(r, c, A, bl, bu, u, lb=l)
            assert ok, msg


@pytest.mark.parametrize("m", [40, 70])
def test_batched_matches_sequential_tall(m):
    """Flights of more than 32 rows (m_pad 64 and 128: the kernel keeps
    such a lane's rows in its global workspace) against both references."""
    c, A, bl, bu, ubs, lbs = _flight(5, K=4, n=2 * m, m=m)
    ress = batch(c, A, bl, bu, ubs, lbs)
    _held(ress, [ref_lp.solve_lp_np(c, A, bl, bu, u, lb=l)
                 for u, l in zip(ubs, lbs)], ref_jax(c, A, bl, bu, ubs, lbs))
    assert any(r.status == OPTIMAL and r.iters > 0 for r in ress)


def test_batched_matches_sequential_warm(seed=7):
    c, A, bl, bu, ubs, _ = _flight(seed, K=4)
    base = solve_lp_np(c, A, bl, bu, np.max(ubs, axis=0))
    ref_base = ref_lp.solve_lp_np(c, A, bl, bu, np.max(ubs, axis=0))
    assert base.status == OPTIMAL
    assert np.array_equal(base.basis, ref_base.basis)
    ress = batch(c, A, bl, bu, ubs, warm_starts=[base] * len(ubs))
    _held(ress, [ref_lp.solve_lp_np(c, A, bl, bu, u, warm_start=ref_base)
                 for u in ubs],
          ref_jax(c, A, bl, bu, ubs, warm_starts=[ref_base] * len(ubs)))


def test_backend_np_is_bit_compatible():
    """The sequential path routes through solve_lp_np verbatim, and the
    port's solve_lp_np is the reference's."""
    c, A, bl, bu, ubs, lbs = _flight(2, K=3)
    ress = solve_lp_batch(c, A, bl, bu, ubs, lbs, backend="np")
    for k, (u, l) in enumerate(zip(ubs, lbs)):
        ref = ref_lp.solve_lp_np(c, A, bl, bu, u, lb=l)
        assert ress[k].status == ref.status
        assert ress[k].obj == ref.obj
        assert ress[k].iters == ref.iters
        assert np.array_equal(ress[k].x, ref.x)
        assert ress[k].notes == ref.notes


def test_masked_done_lane_frozen_exactly():
    """A lane that converges early is frozen: its answer is bit-identical
    whether its neighbours pivot on or not (alone vs in a mixed flight),
    and the slow lanes match their sequential and batched references."""
    rng = np.random.default_rng(4)
    n, m = 30, 3
    c = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    ub = np.ones(n)
    act = A @ (0.5 * ub)
    bl, bu = act - 1.0, act + 1.0
    ub_fast = np.full(n, 1e-3)
    blf = np.minimum(bl, A @ np.zeros(n))
    flight = [ub_fast, ub, ub * 0.7, ub * 0.4]
    alone = solve_lp_batch(c, A, blf, bu, [ub_fast], backend="np")[0]
    mixed = batch(c, A, blf, bu, flight)
    assert mixed[0].status == alone.status
    if alone.status == OPTIMAL:
        assert mixed[0].obj == pytest.approx(alone.obj, abs=1e-12)
        assert mixed[0].iters == alone.iters
        assert np.array_equal(np.sort(mixed[0].basis), np.sort(alone.basis))
    jx = ref_jax(c, A, blf, bu, flight)
    for k in (1, 2, 3):
        _lane(mixed[k], ref_lp.solve_lp_np(c, A, blf, bu, flight[k]),
              f"lane {k} vs solve_lp_np")
        _lane(mixed[k], jx[k], f"lane {k} vs the batched reference")


def _bb_instance():
    rng = np.random.default_rng(9)
    n = 60
    vals = rng.normal(10, 2, n)
    c = rng.normal(size=n)
    A = np.stack([np.ones(n), vals])
    return c, A, np.array([5.0, 57.0]), np.array([9.0, 63.0]), n


@pytest.mark.parametrize("W,backend", [(1, None), (4, None),
                                       (16, "device")])
def test_wave_bb_matches_node_loop(W, backend):
    """W = 1 is the node loop; W > 1 waves find the same optimum, and each
    W explores the tree the reference's wave engine explores (nodes and LP
    iterations equal)."""
    c, A, bl, bu, n = _bb_instance()
    r = solve_ilp(c, A, bl, bu, np.ones(n), wave_width=W,
                  batch_backend=backend, device="cpu")
    ref = ref_ilp(c, A, bl, bu, np.ones(n), wave_width=W,
                  batch_backend=None if backend is None else "jax")
    r1 = ref_ilp(c, A, bl, bu, np.ones(n), wave_width=1)
    assert r.feasible and r.status == ILP_OPTIMAL == ref.status
    assert r.obj == pytest.approx(r1.obj, abs=1e-9)
    assert np.array_equal(r.x, r1.x) and np.array_equal(r.x, ref.x)
    assert (r.nodes, r.lp_iters) == (ref.nodes, ref.lp_iters)
    act = A @ r.x
    assert np.all(act >= bl - 1e-6) and np.all(act <= bu + 1e-6)


def test_budget_exhaustion_mid_batch_salvages_incumbent():
    """The pivot budget dies mid-search: the wave B&B returns what the
    reference returns (the incumbent, ILP_LIMIT or optimal), and a
    flight under an already dead budget reports BUDGET at once."""
    c, A, bl, bu, n = _bb_instance()
    full = solve_ilp(c, A, bl, bu, np.ones(n), wave_width=8,
                     batch_backend="device", device="cpu")
    assert full.status == ILP_OPTIMAL
    budget = guard.SolveBudget(max_pivots=200).start()
    r = solve_ilp(c, A, bl, bu, np.ones(n), wave_width=8,
                  batch_backend="device", budget=budget, device="cpu")
    ref_budget = ref_guard.SolveBudget(max_pivots=200).start()
    ref = ref_ilp(c, A, bl, bu, np.ones(n), wave_width=8,
                  batch_backend="jax", budget=ref_budget)
    assert r.status in (ILP_LIMIT, ILP_OPTIMAL)
    assert (r.status, r.nodes, r.lp_iters) == (ref.status, ref.nodes,
                                               ref.lp_iters)
    assert budget.pivots_spent == ref_budget.pivots_spent > 0
    if r.feasible:
        assert np.array_equal(r.x, ref.x)
        act = A @ r.x
        assert np.all(act >= bl - 1e-6) and np.all(act <= bu + 1e-6)
        assert np.all(np.abs(r.x - np.round(r.x)) < 1e-9)
    dead = guard.SolveBudget(max_pivots=1)
    dead.charge_pivots(5)
    ress = batch(c, A, bl, bu, [np.ones(n)] * 3, budget=dead)
    assert all(res.status == BUDGET for res in ress)
    assert all(res.notes == ("budget: exhausted before LP solve",)
               for res in ress)


def test_budget_charged_as_sum_of_lane_pivots():
    c, A, bl, bu, ubs, lbs = _flight(5, K=4)
    budget = guard.SolveBudget(max_pivots=100_000).start()
    mon = guard.NumericalMonitor()
    ress = batch(c, A, bl, bu, ubs, lbs, budget=budget, monitor=mon)
    assert budget.pivots_spent == sum(r.iters for r in ress)
    ref_budget = ref_guard.SolveBudget(max_pivots=100_000).start()
    ref_jax(c, A, bl, bu, ubs, lbs, budget=ref_budget)
    assert budget.pivots_spent == ref_budget.pivots_spent


@pytest.mark.parametrize("max_pivots", [9, 14, 21, 30])
def test_lockstep_budget_matches_reference(max_pivots):
    """A shared pivot budget that runs out mid-flight: the lanes move in
    lockstep, so some stop at the cap while others have finished; every
    lane's status, iterations and notes equal the reference's, and both
    charge the same pivots."""
    c, A, bl, bu, ubs, lbs = _flight(3, K=8, n=60, m=5)
    free = batch(c, A, bl, bu, ubs, lbs)
    its = [r.iters for r in free]
    assert len(set(its)) > 1           # lanes end at different trips
    budget = guard.SolveBudget(max_pivots=max_pivots).start()
    ress = batch(c, A, bl, bu, ubs, lbs, budget=budget)
    ref_budget = ref_guard.SolveBudget(max_pivots=max_pivots).start()
    refs = ref_jax(c, A, bl, bu, ubs, lbs, budget=ref_budget)
    assert [(r.status, r.iters, r.notes) for r in ress] == \
        [(r.status, r.iters, r.notes) for r in refs]
    assert budget.pivots_spent == ref_budget.pivots_spent
    for r, f in zip(ress, free):
        assert r.iters == min(f.iters, lockstep_trips(its, max_pivots))
    for r, ref in zip(ress, refs):
        _lane(r, ref)


def test_lockstep_trips_is_the_lockstep_loop():
    """The trip count the second launch uses equals a lockstep loop's."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        its = rng.integers(0, 12, rng.integers(1, 9))
        cap = int(rng.integers(1, 60))
        spent, trips = 0, 0
        while np.any(its > trips) and spent < cap:
            spent += int(np.sum(its > trips))
            trips += 1
        assert lockstep_trips(its, cap) == trips


def test_compile_classes_bounded_across_K():
    """Varying K inside one class reuses the workspace: growing a flight
    from 5 to 8 lanes makes no new one (K = 6, 7, 8 share K_pad = 8)."""
    c, A, bl, bu, ubs, lbs = _flight(1, K=8)
    before = batch_cache_stats()
    batch(c, A, bl, bu, ubs[:5], lbs[:5])
    mid = batch_cache_stats()
    batch(c, A, bl, bu, ubs[:6], lbs[:6])
    batch(c, A, bl, bu, ubs[:7], lbs[:7])
    batch(c, A, bl, bu, ubs[:8], lbs[:8])
    after = batch_cache_stats()
    assert mid["misses"] >= before["misses"]
    assert after["misses"] == mid["misses"]
    assert after["hits"] >= mid["hits"] + 3
    assert after["size"] <= after["maxsize"]
    assert batch_stats()["dispatches"] >= 4


def test_empty_and_single_flights():
    c, A, bl, bu, ubs, lbs = _flight(6, K=1)
    assert solve_lp_batch(c, A, bl, bu, []) == []
    # K = 1 under "auto" runs the numpy twin (bit-compatible) on the host,
    # and so needs no card even with the default device
    res = solve_lp_batch(c, A, bl, bu, ubs, lbs)[0]
    ref = ref_lp.solve_lp_np(c, A, bl, bu, ubs[0], lb=lbs[0])
    assert res.status == ref.status and res.obj == ref.obj
    assert res.iters == ref.iters
    _lane(batch(c, A, bl, bu, ubs, lbs)[0], ref)


def test_box_infeasible_lane_decided_on_host():
    c, A, bl, bu, ubs, lbs = _flight(8, K=3)
    lbs = [lb.copy() for lb in lbs]
    lbs[1][:] = 2.0          # lb > ub: box-infeasible lane
    ress = batch(c, A, bl, bu, ubs, lbs)
    assert ress[1].status == INFEASIBLE
    jx = ref_jax(c, A, bl, bu, ubs, lbs)
    for k in (0, 2):
        _lane(ress[k], ref_lp.solve_lp_np(c, A, bl, bu, ubs[k], lb=lbs[k]))
        _lane(ress[k], jx[k])


def test_warm_rejection_per_lane():
    """An out-of-range warm basis falls cold for its lane only, with the
    rejection note; the other lanes keep their warm starts."""
    c, A, bl, bu, ubs, _ = _flight(10, K=3)
    base = solve_lp_np(c, A, bl, bu, np.max(ubs, axis=0))
    ref_base = ref_lp.solve_lp_np(c, A, bl, bu, np.max(ubs, axis=0))
    assert base.status == OPTIMAL
    bad = WarmStart(np.full(A.shape[0], 10_000, np.int64), None)
    ref_bad = ref_lp.WarmStart(bad.basis, None)
    ress = batch(c, A, bl, bu, ubs, warm_starts=[base, bad, base])
    refs = ref_jax(c, A, bl, bu, ubs, warm_starts=[ref_base, ref_bad,
                                                   ref_base])
    assert any(n.startswith("warm_start_rejected")
               for n in ress[1].notes), ress[1].notes
    assert ress[1].notes == refs[1].notes
    for k in (0, 2):
        assert not any(n.startswith("warm_start_rejected")
                       for n in ress[k].notes)
        _lane(ress[k], ref_lp.solve_lp_np(c, A, bl, bu, ubs[k],
                                          warm_start=ref_base))
        _lane(ress[k], refs[k])


def test_backend_names():
    c, A, bl, bu, ubs, lbs = _flight(0, K=3)
    with pytest.raises(ValueError, match="device"):
        solve_lp_batch(c, A, bl, bu, ubs, backend="jax")
    with pytest.raises(ValueError, match="unknown backend"):
        solve_lp_batch(c, A, bl, bu, ubs, backend="gpu")


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_solve_lp_is_one_lane_of_the_engine(seed):
    """``solve_lp``, the reference's jitted twin, as one lane of the
    batched engine: the reference's ``solve_lp`` and ``solve_lp_np``
    under the lane bar, cold and warm."""
    c, A, bl, bu, ubs, lbs = _flight(seed)
    got = port_lp.solve_lp(c, A, bl, bu, ubs[0], lb=lbs[0], device="cpu")
    _lane(got, ref_lp.solve_lp(c, A, bl, bu, ubs[0], lb=lbs[0]))
    _lane(got, ref_lp.solve_lp_np(c, A, bl, bu, ubs[0], lb=lbs[0]))
    warm = port_lp.solve_lp(c, A, bl, bu, ubs[1], warm_start=got,
                            device="cpu")
    ref_warm = ref_lp.solve_lp(c, A, bl, bu, ubs[1],
                               warm_start=ref_lp.solve_lp(
                                   c, A, bl, bu, ubs[0], lb=lbs[0]))
    _lane(warm, ref_warm)
    # the reference's single twin factorizes on its first trip, after its
    # drift gate has measured the residual of the identity it starts
    # with, so a warm start there also notes one "drift" event; the
    # batched engine (the reference's and the port's) factorizes every
    # lane before the loop.  Every other note is the same.
    assert [nt for nt in warm.notes if not nt.startswith("drift")] == \
        [nt for nt in ref_warm.notes if not nt.startswith("drift")]


def test_solve_lp_budget_and_mesh(tmp_path):
    c, A, bl, bu, ubs, _ = _flight(2)
    got = port_lp.solve_lp(c, A, bl, bu, ubs[0], device="cpu",
                           budget=guard.SolveBudget(max_pivots=0))
    ref = ref_lp.solve_lp(c, A, bl, bu, ubs[0],
                          budget=ref_guard.SolveBudget(max_pivots=0))
    assert (got.status, got.iters, got.notes) == (ref.status, ref.iters,
                                                  ref.notes)
    assert np.array_equal(got.basis, ref.basis)
    got = port_lp.solve_lp(c, A, bl, bu, ubs[0], device="cpu", max_iters=1)
    ref = ref_lp.solve_lp(c, A, bl, bu, ubs[0], max_iters=1)
    assert (got.status, got.iters) == (ref.status, ref.iters)
    # mesh= (item 6, landed) routes to the distributed backend: on a
    # world-1 gloo mesh the reference's answer on its (1, 1) mesh
    import jax
    with W.world1(tmp_path / "store"):
        got = port_lp.solve_lp(c, A, bl, bu, ubs[0], mesh=W.mesh(),
                               device="cpu")
        with pytest.raises(TypeError, match="DeviceMesh"):
            port_lp.solve_lp(c, A, bl, bu, ubs[0], mesh=object(),
                             device="cpu")
    ref = ref_lp.solve_lp(c, A, bl, bu, ubs[0],
                          mesh=jax.make_mesh((1, 1), W.NAMES))
    assert (got.status, got.iters, got.pivot_stats) == (
        ref.status, ref.iters, ref.pivot_stats)
    assert got.obj == pytest.approx(ref.obj, rel=1e-9, abs=1e-9)
    assert np.array_equal(np.sort(got.basis), np.sort(ref.basis))


# ---------------------------------------- the warp path's ordered-merge walk


def _select_reference(ratio, cost, elig, delta):
    """The reference's BFRT select (``repro/core/lp.py::_pivot_core``):
    ``np.argsort(kind="stable")`` of the ratios (ineligible ones +inf),
    ``np.cumsum`` of the flip costs in that order, the first eligible
    position whose sum reaches |delta| - 1e-12 (the left ``searchsorted``
    rule on a sum that only grows); every eligible breakpoint before it
    flips.  Returns (q, flips, the sum there, has_cross); without a
    crossing the sum over every eligible breakpoint, in order."""
    N = len(ratio)
    r = np.where(elig, ratio, np.inf)
    c = np.where(elig, cost, 0.0)
    order = np.argsort(r, kind="stable")
    csum = np.cumsum(c[order])
    thr = abs(delta) - 1e-12
    crossed = (csum >= thr) & elig[order]
    if not crossed.any():
        e = order[elig[order]]
        return -1, None, float(np.cumsum(cost[e])[-1]) if e.size else 0.0, \
            False
    pos = int(np.argmax(crossed))
    q = int(order[pos])
    if np.all(np.isfinite(c)) and np.all(c >= 0):   # the searchsorted rule
        e = order[elig[order]]
        ecs = np.cumsum(cost[e])
        assert int(e[np.searchsorted(ecs, thr, side="left")]) == q
    idx = np.arange(N)
    flips = elig & ((r < r[q]) | ((r == r[q]) & (idx < q)))
    return q, flips, float(csum[pos]), True


def _same_bits(a: float, b: float) -> bool:
    return (np.isnan(a) and np.isnan(b)) or \
        np.float64(a).view(np.int64) == np.float64(b).view(np.int64)


def _hold_merge_walk(ratio, cost, elig, delta, lanes=32):
    """The merge walk against the reference: q and has_cross always; the
    running sum bit for bit wherever the merge ran; the flip set where
    it crossed.  Returns (q, walked)."""
    from repro_torch.kernels.lp_batch import bfrt_merge_walk_plain
    ratio, cost = np.asarray(ratio, float), np.asarray(cost, float)
    elig = np.asarray(elig, bool)
    q, flips, base, has, walked = bfrt_merge_walk_plain(ratio, cost, elig,
                                                        delta, lanes)
    wq, wflips, wbase, whas = _select_reference(ratio, cost, elig, delta)
    assert (q, has) == (wq, whas)
    if walked:
        assert _same_bits(base, wbase), (base, wbase)
    if has:
        assert np.array_equal(flips, wflips)
    return q, walked


def _delta_for(s: float):
    """A delta whose threshold |delta| - 1e-12 is exactly s, or None."""
    d = s + 1e-12
    for _ in range(8):
        t = d - 1e-12
        if t == s:
            return d
        d = np.nextafter(d, np.inf if t < s else -np.inf)
    return None


@pytest.mark.parametrize("case", ["ties", "nan_after_inf", "inf",
                                  "zero_costs", "partial_sum", "no_crossing",
                                  "nan_cost", "negative_zero", "n33", "n1",
                                  "nan_crossing"])
def test_merge_walk_cases(case):
    """The merge walk's q, flip set and running sum, bit for bit, against
    the reference's argsort + cumsum on hand-made selects."""
    rng = np.random.default_rng(0)
    N = {"n33": 33, "n1": 1}.get(case, 100)
    ratio = rng.integers(0, 6, N).astype(float)          # ties everywhere
    cost = rng.uniform(0.0, 1.0, N)
    elig = rng.uniform(size=N) < 0.7
    delta = 0.5 * float(cost[elig].sum()) if elig.any() else 1.0
    if case == "nan_after_inf":
        ratio[::7], ratio[3::11] = np.nan, np.inf
        delta = float(cost[elig].sum()) * 0.97
    elif case == "inf":
        ratio[::2] = np.inf
    elif case == "zero_costs":
        cost[::3] = 0.0
    elif case == "partial_sum":
        e = np.argsort(np.where(elig, ratio, np.inf), kind="stable")
        e = e[elig[e]]
        for k in range(len(e)):                # every partial sum exactly
            delta = _delta_for(float(np.cumsum(cost[e])[k]))
            if delta is not None:
                assert _hold_merge_walk(ratio, cost, elig, delta)[0] == e[k]
        return
    elif case == "no_crossing":
        delta = float(cost.sum()) + 1.0
    elif case == "nan_cost":
        cost[np.flatnonzero(elig)[3]] = np.nan
        delta = float(np.nansum(cost)) * 0.9
    elif case == "negative_zero":
        ratio[::4] = -0.0
        ratio[1::4] = 0.0
    elif case == "nan_crossing":
        ratio[:] = np.nan
        ratio[:5] = 1.0
    q, walked = _hold_merge_walk(ratio, cost, elig, delta)
    if case == "no_crossing":
        assert q == -1 and not walked           # the shortcut
    if case == "nan_crossing":
        assert q >= 0 and np.isnan(ratio[q])


_RATIOS = st.one_of(st.sampled_from([0.0, -0.0, 0.5, 1.0, 1.0, 2.5,
                                     np.inf, np.nan]),
                    st.floats(0.0, 10.0))
_COSTS = st.one_of(st.sampled_from([0.0, 0.125, 1.0, 3.0]),
                   st.floats(0.0, 5.0))


@st.composite
def _selects(draw):
    N = draw(st.integers(1, 150))
    ratio = np.array(draw(st.lists(_RATIOS, min_size=N, max_size=N)))
    cost = np.array(draw(st.lists(_COSTS, min_size=N, max_size=N)))
    elig = np.array(draw(st.lists(st.booleans(), min_size=N,
                                  max_size=N)))
    kind = draw(st.sampled_from(["any", "partial"]))
    delta = draw(st.floats(-20.0, 20.0))
    if kind == "partial" and elig.any():
        e = np.argsort(np.where(elig, ratio, np.inf), kind="stable")
        e = e[elig[e]]
        k = draw(st.integers(0, len(e) - 1))
        d = _delta_for(float(np.cumsum(cost[e])[k]))
        delta = delta if d is None else d
    lanes = draw(st.sampled_from([32, 32, 4, 1]))
    return ratio, cost, elig, delta, lanes


@settings(max_examples=300, deadline=None)
@given(_selects())
def test_merge_walk_is_the_sequential_select(case):
    """Random selects (ties, NaN and +inf ratios, -0, zero costs,
    thresholds on a partial sum, any N; runs over 32, 4 or 1
    threads): the merge walk reports the reference's q, flip set and
    running sum, bit for bit."""
    ratio, cost, elig, delta, lanes = case
    _hold_merge_walk(ratio, cost, elig, delta, lanes)


@settings(max_examples=300, deadline=None)
@given(st.integers(1, 120), st.integers(-8, 8), st.integers(0, 2 ** 32 - 1),
       st.sampled_from([32, 4]))
def test_merge_walk_shortcut_is_sound(N, ulps, seed, lanes):
    """Thresholds within a few ulps of the walk's last running sum (the
    sum of every eligible cost in (ratio, index) order): the no-crossing
    shortcut fires only where the walk finds no crossing, and the merge
    otherwise finds the reference's q."""
    rng = np.random.default_rng(seed)
    ratio = rng.integers(0, 4, N).astype(float)
    cost = rng.uniform(0.0, 1.0, N) * 10.0 ** rng.integers(-3, 4, N)
    elig = rng.uniform(size=N) < 0.8
    e = np.argsort(np.where(elig, ratio, np.inf), kind="stable")
    e = e[elig[e]]
    last = float(np.cumsum(cost[e])[-1]) if e.size else 0.0
    thr = last + ulps * np.spacing(last)
    delta = _delta_for(thr)
    if delta is None:
        delta = thr + 1e-12
    _hold_merge_walk(ratio, cost, elig, delta, lanes)
