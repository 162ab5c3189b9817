"""The port's LP solvers against the JAX reference, on the CPU.

``solve_lp_np`` is host numpy in both packages and must agree exactly in
its decisions (status, pivot count, basis) and to 1e-9 in the objective.
The device twin ``solve_lp_kernel`` runs here with ``device="cpu"`` (the
kernels' plain versions); its bucketed BFRT may break pivot ties
differently, so it is held to the same status, the objective within 1e-6
and an independent optimality certificate.
"""
import functools

import numpy as np
import pytest
import torch

from repro.core import lp as ref_lp
from repro_torch.core import guard
from repro_torch.core import lp as port_lp
from repro_torch.core.lp_batch import solve_lp_batch
from repro_torch.core.lp_kernel import solve_lp_kernel

kernel_cpu = functools.partial(solve_lp_kernel, device="cpu")
SEEDS = [0, 1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 144, 233, 377, 610, 987]


def _random_lp(seed):
    """The random LPs of the reference's ``tests/test_lp_kernel.py``."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 40))
    m = int(rng.integers(1, 5))
    c = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    ub = rng.integers(1, 4, size=n).astype(float)
    x0 = rng.uniform(0, 1, n) * ub
    act = A @ x0
    width = np.abs(rng.normal(size=m)) * 2
    bl = act - width * rng.uniform(0, 1, m)
    bu = act + width * rng.uniform(0, 1, m)
    return c, A, bl, bu, ub


@pytest.mark.parametrize("seed", SEEDS)
def test_solve_lp_np_matches_reference(seed):
    c, A, bl, bu, ub = _random_lp(seed)
    want = ref_lp.solve_lp_np(c, A, bl, bu, ub)
    got = port_lp.solve_lp_np(c, A, bl, bu, ub)
    assert got.status == want.status
    assert got.iters == want.iters
    np.testing.assert_array_equal(got.basis, want.basis)
    np.testing.assert_array_equal(got.at_upper, want.at_upper)
    assert got.obj == pytest.approx(want.obj, rel=1e-9, abs=1e-9)


@pytest.mark.parametrize("seed", SEEDS)
def test_kernel_lp_matches_reference(seed):
    c, A, bl, bu, ub = _random_lp(seed)
    want = ref_lp.solve_lp_np(c, A, bl, bu, ub)
    got = kernel_cpu(c, A, bl, bu, ub, max_iters=2000)
    assert got.status == want.status
    if want.status == port_lp.OPTIMAL:
        assert got.obj == pytest.approx(want.obj, rel=1e-6, abs=1e-6)
        ok, msg = port_lp.verify_optimality(got, c, A, bl, bu, ub)
        assert ok, msg
        ok, msg = ref_lp.verify_optimality(got, c, A, bl, bu, ub)
        assert ok, msg


def test_kernel_lp_package_query_shape():
    """A package-query-shaped LP (count + sum bounds): objective to 1e-8
    of the reference's numpy twin, and certified optimal."""
    rng = np.random.default_rng(7)
    n = 3000
    c = rng.normal(size=n)
    A = np.stack([np.ones(n), rng.normal(14, 1.5, n)])
    bl = np.array([15.0, 14 * 30 - 9.0])
    bu = np.array([45.0, 14 * 30 + 9.0])
    r = kernel_cpu(c, A, bl, bu, np.ones(n))
    assert r.status == port_lp.OPTIMAL
    ok, msg = port_lp.verify_optimality(r, c, A, bl, bu, np.ones(n))
    assert ok, msg
    want = ref_lp.solve_lp_np(c, A, bl, bu, np.ones(n))
    assert r.obj == pytest.approx(want.obj, rel=1e-8)


@pytest.mark.parametrize("solver", ["np", "kernel"])
def test_warm_start_contract_matches_reference(solver):
    """A warm start from the optimal basis: the optimality check alone
    (one iteration) on the reference's numpy twin and the port's twins
    alike, same objective."""
    c, A, bl, bu, ub = _random_lp(3)
    cold = ref_lp.solve_lp_np(c, A, bl, bu, ub)
    assert cold.status == ref_lp.OPTIMAL
    warm_ref = ref_lp.solve_lp_np(c, A, bl, bu, ub, warm_start=cold)
    ws = port_lp.WarmStart(cold.basis.copy(), cold.at_upper.copy())
    fn = port_lp.solve_lp_np if solver == "np" else kernel_cpu
    warm = fn(c, A, bl, bu, ub, warm_start=ws)
    assert warm.status == warm_ref.status == port_lp.OPTIMAL
    assert warm.iters == warm_ref.iters < cold.iters
    assert warm.obj == pytest.approx(warm_ref.obj, rel=1e-9, abs=1e-9)


def test_kernel_lp_budget_contract():
    """The budget contract: a spent budget returns BUDGET before any
    pivot; a live one is charged every pivot; ``max_iters`` caps the
    loop at ITER_LIMIT."""
    rng = np.random.default_rng(7)
    n = 400
    c = rng.normal(size=n)
    A = np.stack([np.ones(n), rng.normal(14, 1.5, n)])
    bl = np.array([15.0, 14 * 30 - 9.0])
    bu = np.array([45.0, 14 * 30 + 9.0])
    ub = np.ones(n)
    r = kernel_cpu(c, A, bl, bu, ub, budget=guard.SolveBudget(max_pivots=0))
    assert (r.status, r.iters) == (port_lp.BUDGET, 0)
    budget = guard.SolveBudget(max_pivots=1000)
    r = kernel_cpu(c, A, bl, bu, ub, budget=budget)
    assert r.status == port_lp.OPTIMAL and r.iters > 2
    assert budget.pivots_spent == r.iters
    r = kernel_cpu(c, A, bl, bu, ub, max_iters=2)
    assert (r.status, r.iters) == (port_lp.ITER_LIMIT, 2)


def test_lp_batch_sequential_matches_reference():
    """Bound-variants through a flight == reference numpy solves lane by
    lane, at K = 2 (the sequential path) and at K = 3 (where "auto" takes
    the batched engine, here its plain version on the CPU, pinned lane by
    lane to the same solves); the reference's backend name "jax" raises
    and names the port's, "device"."""
    c, A, bl, bu, ub = _random_lp(5)
    ubs = [ub, np.minimum(ub, 1.0), np.minimum(ub, 0.5)]
    for flight in (ubs[:2], ubs):
        got = solve_lp_batch(c, A, bl, bu, flight, device="cpu")
        assert len(got) == len(flight)
        for g, u in zip(got, flight):
            want = ref_lp.solve_lp_np(c, A, bl, bu, u)
            assert (g.status, g.iters) == (want.status, want.iters)
            assert g.obj == pytest.approx(want.obj, rel=1e-9, abs=1e-9)
    with pytest.raises(ValueError, match="'device'"):
        solve_lp_batch(c, A, bl, bu, [ub], backend="jax")


def test_lp_batch_device_backend_needs_a_card():
    """The batched engine on the default device raises without CUDA (no
    silent CPU fallback), forced or under "auto" at K > 2; K <= 2 under
    "auto" stays on the host and needs no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card contract is moot")
    c, A, bl, bu, ub = _random_lp(5)
    ubs = [ub, np.minimum(ub, 1.0), np.minimum(ub, 0.5)]
    with pytest.raises(RuntimeError, match="cuda"):
        solve_lp_batch(c, A, bl, bu, ubs[:1], backend="device",
                       device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        solve_lp_batch(c, A, bl, bu, ubs)
    assert len(solve_lp_batch(c, A, bl, bu, ubs[:2])) == 2
