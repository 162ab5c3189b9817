"""Distributed pricing on ``torch.distributed`` (``repro_torch.core.
distributed``) against the reference's ``shard_map`` backend.

Worlds of 1 (in this process), 2 (mesh (1, 2)) and 4 (mesh (2, 2)) ranks
on gloo run the cases of this module (``torch_dist_worker``); the
reference runs on JAX host meshes of the same shapes (the conftest's
forced host devices).  Rank r holds the same columns as the reference's
shard r, so the pricing step, the update and refresh steps and whole
solves are compared case for case: the reference test's bars
(``tests/test_distributed.py``), the same pivots, and every rank's
result bit for bit equal to rank 0's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from repro.core import distributed as ref_dist
from repro.core.lp import (OPTIMAL, solve_lp_np as ref_solve_lp_np,
                           verify_optimality)
from repro.kernels.ref import bfrt_sequential_ref
from repro.runtime import faults as ref_faults
from repro_torch.core import distributed as dist_mod
from repro_torch.core.lp import solve_lp

WORLDS = (1, 2, 4)
STEP_SEEDS = (0, 1, 2)
SOLVE_SEEDS = (0, 1, 3)
BUCKETS = (256, dist_mod.NUM_BUCKETS)


def _random_state(seed, m=4, n=4096):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    c = rng.normal(size=n)
    lo = np.zeros(n)
    hi = rng.uniform(1, 3, n)
    state = rng.integers(0, 3, n).astype(np.int32)
    rho = rng.normal(size=m)
    y = rng.normal(size=m)
    d = c - y @ A                       # "maintained" reduced costs
    return A, d, lo, hi, state, rho


def _package_lp(seed, m=6, n=800):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=n)
    A = np.stack([np.ones(n)] + [
        rng.normal(rng.uniform(-2, 5), rng.uniform(0.5, 2), n)
        for _ in range(m - 1)])
    x0 = np.zeros(n)
    x0[rng.choice(n, 16, replace=False)] = 1.0
    act = A @ x0
    w = np.maximum(np.abs(act) * 0.05, 0.5)
    return c, A, act - w, act + w, np.ones(n)


def _random_lp(seed, n=160, m=6):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    ub = rng.integers(1, 4, size=n).astype(float)
    x0 = rng.uniform(0, 1, n) * ub
    act = A @ x0
    width = np.abs(rng.normal(size=m)) * 2
    bl = act - width * rng.uniform(0, 1, m)
    bu = act + width * rng.uniform(0, 1, m)
    return c, A, bl, bu, ub


def _sibling_warm(seed):
    """The reference test's warm basis: the numpy twin on a sibling LP."""
    c, A, bl, bu, ub = _package_lp(seed)
    c2 = c + 0.01 * np.random.default_rng(42).normal(size=len(c))
    sib = ref_solve_lp_np(c2, A, bl, bu, ub)
    return sib.basis.copy(), sib.at_upper.copy()


INFEASIBLE_BOX = (np.ones(4), np.ones((1, 4)), np.array([10.0]),
                  np.array([20.0]), np.ones(4))


def _update_inputs(n=4096):
    rng = np.random.default_rng(11)
    return dict(d=rng.normal(size=n), state=rng.integers(0, 3, n),
                alpha=rng.normal(size=n), flip=rng.random(n) < 0.1,
                theta=0.37, q=int(n * 0.8) + 3, leave=5, leave_up=True)


def _refresh_inputs(m=4, n=4096):
    rng = np.random.default_rng(12)
    return dict(A=rng.normal(size=(m, n)), cf=rng.normal(size=n),
                state=rng.integers(0, 3, n).astype(np.int32),
                lo=np.zeros(n), hi=rng.uniform(1, 3, n),
                y=rng.normal(size=m))


@functools.lru_cache(maxsize=1)
def _cases():
    cases = []
    for seed in STEP_SEEDS:
        A, d, lo, hi, state, rho = _random_state(seed)
        for nb in BUCKETS:
            cases.append((f"step {seed} {nb}", "step", dict(
                A=A, d=d, lo=lo, hi=hi, state=state, rho=rho, s=1.0,
                budget=25.0, num_buckets=nb)))
    A, d, lo, hi, state, rho = _random_state(1, 3, 1024)
    cases.append(("step infeasible", "step", dict(
        A=A, d=d, lo=lo, hi=hi, state=state, rho=rho, s=1.0,
        budget=1e12)))
    cases.append(("update", "update", _update_inputs()))
    cases.append(("refresh", "refresh", _refresh_inputs()))
    for seed in SOLVE_SEEDS:
        lp = _package_lp(seed)
        cases.append((f"cold {seed}", "solve", dict(lp=lp)))
        cases.append((f"warm {seed}", "solve", dict(
            lp=lp, warm_start=_sibling_warm(seed))))
    cases.append(("gather_k 2", "solve", dict(lp=_package_lp(2, n=1500),
                                               gather_k=2)))
    cases.append(("infeasible box", "solve", dict(lp=INFEASIBLE_BOX)))
    cases.append(("route", "solve", dict(lp=_package_lp(5, n=300),
                                         route=True)))
    cases.append(("shard", "shard_fault", dict(lp=_random_lp(7))))
    return tuple(cases)


def _kw(name):
    return {n: k for n, _, k in _cases()}[name]


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    with W.world1(tmp_path_factory.mktemp("world1") / "store"):
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory, world1):
    """{world: [rank 0's results, rank 1's, ...]}, every case at each."""
    cases = _cases()
    out = {1: [W.run(cases)]}
    for world in WORLDS[1:]:
        out[world] = W.spawn(world, cases,
                             tmp_path_factory.mktemp(f"world{world}"))
    return out


def _ref_mesh(world):
    return jax.make_mesh(W.MESHES[world], W.NAMES)


@pytest.fixture(scope="module")
def ref_solves():
    """The reference's ``solve_lp_dist`` on each case, by world."""
    memo = {}

    def get(world, name):
        key = (world, name)
        if key not in memo:
            kw = dict(_kw(name))
            lp = kw.pop("lp")
            kw.pop("route", None)
            memo[key] = ref_dist.solve_lp_dist(*lp, mesh=_ref_mesh(world),
                                               **kw)
        return memo[key]
    return get


def _joined(results, key):
    """A sharded output put back together in rank order."""
    return np.concatenate([r[key] for r in results])


def _same_on_every_rank(results, name):
    first = results[0][name]
    for other in results[1:]:
        for k, v in first.items():
            got = other[name][k]
            if isinstance(v, np.ndarray):
                assert v.dtype == got.dtype and v.tobytes() == got.tobytes(), k
            else:
                assert got == v, k


def _ref_step(world, A, d, lo, hi, state, rho, s, budget, **kw):
    m, n = A.shape
    step, _, _ = ref_dist.make_pq_step(_ref_mesh(world), m, n, **kw)
    out = step(*(jnp.asarray(x) for x in (A, d, lo, hi, state, rho)),
               jnp.asarray(np.asarray(s)), jnp.asarray(np.asarray(budget)))
    return [np.asarray(v) for v in out]


# ------------------------------------------------------------ the steps


@pytest.mark.parametrize("nb", BUCKETS)
@pytest.mark.parametrize("seed", STEP_SEEDS)
@pytest.mark.parametrize("world", WORLDS)
def test_pq_step_matches_reference(runs, world, seed, nb):
    """Alpha to 1e-10; q, has_cross, exact, at_up_q, n_flips and the flip
    mask equal to the reference step's on the same mesh shape; r_best,
    d_q, Acol and fvec to the reference test's bars; the selection the
    sequential BFRT's."""
    name = f"step {seed} {nb}"
    res = [r[name] for r in runs[world]]
    kw = _kw(name)
    ref = _ref_step(world, **kw)
    (alpha_r, flips_r, r_best_r, q_r, d_q_r, at_up_r, acol_r, fvec_r,
     n_flips_r, cross_r, exact_r) = ref
    got = res[0]
    np.testing.assert_allclose(_joined(res, "alpha"), alpha_r, atol=1e-10)
    np.testing.assert_array_equal(_joined(res, "flip_mask"), flips_r)
    for k, want in (("q", q_r), ("has_cross", cross_r), ("exact", exact_r),
                    ("at_up_q", at_up_r), ("n_flips", n_flips_r)):
        assert got[k] == want, k
    assert float(got["r_best"]) == pytest.approx(float(r_best_r))
    assert float(got["d_q"]) == pytest.approx(float(d_q_r))
    np.testing.assert_allclose(got["Acol"], acol_r)
    np.testing.assert_allclose(got["fvec"], fvec_r, atol=1e-8)
    # the sequential rule on the same maintained d (no recompute)
    A, d, lo, hi, state, rho = (kw[k] for k in ("A", "d", "lo", "hi",
                                                 "state", "rho"))
    alpha = rho @ A
    tol = 1e-9
    at_up = state == 1
    elig = (state < 2) & (((~at_up) & (alpha > tol))
                          | (at_up & (alpha < -tol)))
    ratio = np.where(elig, np.maximum(
        d / np.where(np.abs(alpha) > tol, alpha, 1), 0), np.inf)
    cost = np.where(elig, np.abs(alpha) * (hi - lo), 0.0)
    q_seq, _, ok_seq = bfrt_sequential_ref(ratio, cost, kw["budget"])
    assert bool(got["has_cross"]) == ok_seq and bool(got["exact"])
    assert float(got["r_best"]) == pytest.approx(ratio[q_seq])
    np.testing.assert_allclose(got["Acol"], A[:, int(got["q"])])
    fl = _joined(res, "flip_mask")
    assert fl.sum() == int(got["n_flips"])
    assert cost[fl].sum() <= kw["budget"] + 1e-9
    dx = np.where(at_up, lo - hi, hi - lo) * fl
    np.testing.assert_allclose(got["fvec"], A @ dx, atol=1e-8)
    for r in res[1:]:                  # replicated outputs: every rank's
        for k in ("r_best", "q", "d_q", "at_up_q", "Acol", "fvec",
                  "n_flips", "has_cross", "exact"):
            assert r[k].tobytes() == got[k].tobytes(), k


@pytest.mark.parametrize("world", WORLDS)
def test_pq_step_infeasible_budget(runs, world):
    """An impossible budget: no crossing, as in the reference."""
    got = runs[world][0]["step infeasible"]
    kw = _kw("step infeasible")
    assert not bool(got["has_cross"])
    assert not bool(_ref_step(world, **kw)[-2])


@pytest.mark.parametrize("world", WORLDS)
def test_update_and_refresh_steps_match_reference(runs, world):
    mesh = _ref_mesh(world)
    u = _update_inputs()
    d, st = ref_dist.make_update_step(mesh)(
        *(jnp.asarray(u[k]) for k in ("d", "state", "alpha", "flip")),
        jnp.asarray(u["theta"]), jnp.asarray(np.int64(u["q"])),
        jnp.asarray(np.int64(u["leave"])), jnp.asarray(u["leave_up"]))
    res = [r["update"] for r in runs[world]]
    # one rounding apart: XLA contracts the reference's axpy into an FMA
    np.testing.assert_allclose(_joined(res, "d"), np.asarray(d), rtol=1e-14,
                               atol=1e-15)
    np.testing.assert_array_equal(_joined(res, "state"), np.asarray(st))
    f = _refresh_inputs()
    d, axn = ref_dist.make_refresh_step(mesh)(
        *(jnp.asarray(f[k]) for k in ("A", "cf", "state", "lo", "hi",
                                      "y")))
    res = [r["refresh"] for r in runs[world]]
    np.testing.assert_allclose(_joined(res, "d"), np.asarray(d),
                               rtol=1e-12, atol=1e-12)
    for r in res:
        np.testing.assert_allclose(r["axn"], np.asarray(axn), rtol=1e-12)
    assert all(r["axn"].tobytes() == res[0]["axn"].tobytes() for r in res)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_big_sentinel_is_finite(dt):
    v = dist_mod.big_sentinel(dt)
    ref = ref_dist.big_sentinel({torch.float32: jnp.float32,
                                 torch.float64: jnp.float64}[dt])
    assert v.dtype == dt and torch.isfinite(v) and torch.isfinite(-v)
    assert float(v) == float(ref)


# ---------------------------------------------------------- full solves


def _check_solve(got, ref, lp, cold=True):
    c, A, bl, bu, ub = lp
    print(f"iters {got['iters']} (reference {ref.iters}), pivot_stats "
          f"{got['pivot_stats']} (reference {ref.pivot_stats})")
    assert got["status"] == ref.status == OPTIMAL
    assert got["obj"] == pytest.approx(ref.obj, rel=1e-8, abs=1e-8)
    assert np.array_equal(np.sort(got["basis"]), np.sort(ref.basis))
    res = ref_solve_lp_np(c, A, bl, bu, ub)
    for k in ("x", "y", "basis", "at_upper"):
        setattr(res, k, got[k])
    ok, why = verify_optimality(res, c, A, bl, bu, ub)
    assert ok, why
    assert got["pivot_stats"]["conservative"] == 0
    assert got["pivot_stats"] == ref.pivot_stats
    if cold:
        assert got["pivot_stats"]["exact"] > 0


@pytest.mark.parametrize("seed", SOLVE_SEEDS)
@pytest.mark.parametrize("world", WORLDS)
def test_cold_solve_matches_reference(runs, ref_solves, world, seed):
    """Cold: the reference's solve_lp_dist on the same mesh shape and the
    numpy twin -- status, objective, sorted basis, the certificate."""
    got = runs[world][0][f"cold {seed}"]
    lp = _package_lp(seed)
    _check_solve(got, ref_solves(world, f"cold {seed}"), lp)
    twin = ref_solve_lp_np(*lp)
    assert got["obj"] == pytest.approx(twin.obj, rel=1e-8, abs=1e-8)
    assert np.array_equal(np.sort(got["basis"]), np.sort(twin.basis))


@pytest.mark.parametrize("seed", SOLVE_SEEDS)
@pytest.mark.parametrize("world", WORLDS)
def test_warm_solve_matches_reference(runs, ref_solves, world, seed):
    """Warm from the sibling LP's basis: the same answer in no more
    pivots than cold."""
    got = runs[world][0][f"warm {seed}"]
    _check_solve(got, ref_solves(world, f"warm {seed}"), _package_lp(seed),
                 cold=False)
    assert got["iters"] <= runs[world][0][f"cold {seed}"]["iters"]


@pytest.mark.parametrize("world", WORLDS)
def test_gather_k_2_goes_conservative_and_stays_optimal(runs, ref_solves,
                                                         world):
    got = runs[world][0]["gather_k 2"]
    ref = ref_solves(world, "gather_k 2")
    lp = _package_lp(2, n=1500)
    print(f"iters {got['iters']} (reference {ref.iters}), pivot_stats "
          f"{got['pivot_stats']} (reference {ref.pivot_stats})")
    assert got["status"] == ref.status == OPTIMAL
    assert got["obj"] == pytest.approx(ref_solve_lp_np(*lp).obj, rel=1e-8,
                                       abs=1e-8)
    assert got["pivot_stats"]["conservative"] > 0
    assert ref.pivot_stats["conservative"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_infeasible_box(runs, ref_solves, world):
    got = runs[world][0]["infeasible box"]
    assert got["status"] == ref_solves(world, "infeasible box").status \
        == ref_solve_lp_np(*INFEASIBLE_BOX).status
    assert got["pivot_stats"] == {"exact": 0, "conservative": 0}


@pytest.mark.parametrize("world", WORLDS)
def test_solve_lp_mesh_routes_to_distributed(runs, world):
    """``solve_lp(mesh=, device="cpu")`` is the distributed entry."""
    got = runs[world][0]["route"]
    ref = ref_solve_lp_np(*_package_lp(5, n=300))
    assert got["status"] == ref.status
    assert got["obj"] == pytest.approx(ref.obj, rel=1e-8, abs=1e-8)
    assert "exact" in got["pivot_stats"]


def test_mesh_and_device_must_agree(world1):
    """A CPU (gloo) mesh with the default ``device="cuda"`` raises; so
    does a mesh that is not a DeviceMesh."""
    lp = _package_lp(5, n=300)
    with pytest.raises(ValueError, match="disagrees"):
        solve_lp(*lp, mesh=W.mesh())
    with pytest.raises(TypeError, match="DeviceMesh"):
        solve_lp(*lp, mesh=object(), device="cpu")


@pytest.mark.parametrize("world", WORLDS)
def test_shard_fault_falls_back_to_single_host(runs, world):
    """The reference's ``test_dist_shard_fault_falls_back_to_single_host``
    side by side: one fire, the fallback, the same answer."""
    lp = _random_lp(7)
    with ref_faults.injected(seed=0,
                             arms={ref_faults.SHARD: dict(times=1)}) as inj:
        ref = ref_dist.solve_lp_dist(*lp, mesh=_ref_mesh(world))
    twin = ref_solve_lp_np(*lp)
    got = runs[world][0]["shard"]
    assert got["fires"] == inj.fire_count(ref_faults.SHARD) == 1
    assert any("single_host_fallback" in nt for nt in got["notes"])
    assert got["pivot_stats"].get("fallback") == ref.pivot_stats.get(
        "fallback") == 1
    assert got["status"] == ref.status == twin.status == OPTIMAL
    assert abs(got["obj"] - twin.obj) <= 1e-6 * (1 + abs(twin.obj))
    assert got["obj"] == pytest.approx(ref.obj, rel=1e-8, abs=1e-8)


@pytest.mark.parametrize("world", WORLDS[1:])
def test_every_rank_returns_the_same_result(runs, world):
    """Basis, x bits, iterations and pivot_stats equal on every rank."""
    for name, kind, _ in _cases():
        if kind in ("solve", "shard_fault"):
            _same_on_every_rank(runs[world], name)


def test_step_cache_counts_as_the_reference(world1):
    """One lookup a solve: hits and misses move as the reference's over
    the same sequence of solves."""
    mesh, ref_mesh = W.mesh(), _ref_mesh(1)
    seq = [_package_lp(0), _package_lp(0), _package_lp(5, n=300),
           _package_lp(1), INFEASIBLE_BOX]
    deltas = []
    port = functools.partial(dist_mod.solve_lp_dist, device="cpu")
    for solve, m, stats in ((port, mesh, dist_mod.step_cache_stats),
                            (ref_dist.solve_lp_dist, ref_mesh,
                             ref_dist.step_cache_stats)):
        before = stats()
        for lp in seq:
            solve(*lp, mesh=m, gather_k=7)
        after = stats()
        deltas.append({k: after[k] - before[k]
                       for k in ("hits", "misses", "lookups")})
    assert deltas[0] == deltas[1]
    assert deltas[0]["lookups"] == len(seq)


def test_pq_input_specs():
    specs = dist_mod.pq_input_specs(6, 4096)
    ref = ref_dist.pq_input_specs(6, 4096)
    assert [tuple(s.shape) for s in specs] == [tuple(r.shape) for r in ref]
    assert [str(s.dtype).split(".")[-1] for s in specs] == \
        [str(r.dtype) for r in ref]
    assert all(s.device.type == "meta" for s in specs)
    assert dist_mod.pq_input_specs(6, 8, torch.float32)[0].dtype == \
        torch.float32
