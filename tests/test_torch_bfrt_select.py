"""The BFRT select on the CPU: the port's plain select and the torch
mirror of its kernel against the exact sequential rule and the JAX
reference.

``bfrt_select_plain`` is what a CPU tensor runs; ``csrc/bfrt.cu`` runs the
same select on the card, and ``bfrt_select_refined_plain`` is its
procedure for a crowded crossing bucket (radix levels over the (ratio,
index) key).  Exact: q, the flip mask and has_cross equal the sequential
walk wherever no running sum lies within rounding of the budget (the cases
below have none).  The JAX select runs as its own tests run it on the CPU
(``bfrt_select_op``: the Pallas histogram in interpret mode).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import bfrt_select_op
from repro.kernels.ref import bfrt_sequential_ref
from repro_torch.kernels import bfrt
from repro_torch.kernels.pricing import ratio_range_plain


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _agree(got, want):
    q, flips, ok = got
    wq, wf, wok = want
    assert bool(ok) == wok
    if wok:
        assert int(q) == wq
        np.testing.assert_array_equal(np.asarray(flips), wf)


@pytest.mark.parametrize("n", [300, 2048])
@pytest.mark.parametrize("frac_elig", [0.05, 0.5])
def test_plain_select_is_the_reference(n, frac_elig):
    rng = np.random.default_rng(10 * n + int(100 * frac_elig))
    r = np.where(rng.random(n) < frac_elig, rng.uniform(0, 10, n), np.inf)
    c = np.where(np.isfinite(r), rng.uniform(0.1, 2, n), 0.0)
    for budget in (0.5, 0.37 * c.sum() + 0.01, 2 * c.sum() + 1):
        want = bfrt_sequential_ref(r, c, budget)
        _agree(bfrt.bfrt_sequential(r, c, budget), want)
        _agree(bfrt_select_op(jnp.asarray(r), jnp.asarray(c), budget), want)
        got = bfrt.bfrt_select_plain(_t(r), _t(c), budget)
        _agree(got, want)
        again = bfrt.bfrt_select_plain(_t(r), _t(c), budget,
                                       rng=ratio_range_plain(_t(r)))
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def _case(kind, n, rng):
    """(ratio, cost, budgets) of one kind; the budgets avoid near-ties."""
    c = rng.uniform(0.1, 2, n)
    if kind == "ties":                  # five distinct ratios
        r = np.where(rng.random(n) < 0.6, rng.integers(0, 5, n) * 0.5,
                     np.inf)
    elif kind == "all_equal":
        r = np.full(n, 1.25)
    elif kind == "zeros":               # degenerate pivots: ratio 0, +-0
        r = np.where(rng.random(n) < 0.5, 0.0, rng.uniform(0, 3, n))
        r[::7] = -0.0
    elif kind == "outlier":             # the rest crowded into bucket 0
        r = rng.uniform(0, 1, n)
        r[n // 3] = 1e6
    elif kind == "mixed_sign":          # keys that differ in the top bit
        r = rng.uniform(-1, 1, n)
        r[5] = 1e6
    elif kind == "none":                # no eligible column
        r = np.full(n, np.inf)
    c = np.where(np.isfinite(r), c, 0.0)
    tot = c.sum()
    return r, c, (0.3 * tot + 0.0137, 0.81 * tot + 0.0071)


KINDS = ["ties", "all_equal", "zeros", "outlier", "mixed_sign", "none"]


@pytest.mark.parametrize("kind", KINDS)
def test_plain_select_edge_cases(kind):
    rng = np.random.default_rng(len(kind))
    r, c, budgets = _case(kind, 400, rng)
    for budget in budgets + (2 * c.sum() + 1,):
        want = bfrt.bfrt_sequential(r, c, budget)
        _agree(bfrt.bfrt_select_plain(_t(r), _t(c), budget,
                                      rng=ratio_range_plain(_t(r))), want)
        if kind in ("ties", "outlier"):
            _agree(bfrt_select_op(jnp.asarray(r), jnp.asarray(c), budget),
                   want)


@pytest.mark.parametrize("where", ["bucket_0", "bucket_127"])
def test_crossing_in_the_first_and_last_bucket(where):
    """The crossing bucket at either end of the 128: the smallest ratio
    alone reaching the budget, and the largest one entering last.  Edges
    from the data's own range leave bucket 127 (above the largest ratio)
    empty, so the second case takes a range that stops at the second
    largest ratio, as a caller's range may."""
    rng = np.random.default_rng(3)
    n = 300
    r = rng.uniform(1, 2, n)
    c = rng.uniform(0.1, 2, n)
    first, last = int(np.argmin(r)), int(np.argmax(r))
    rr = _t([r.min(), np.sort(r)[-2]])
    edges = bfrt.edges_from_range(rr)
    _, counts = bfrt.bfrt_histogram_plain(_t(r), _t(c), edges)
    if where == "bucket_0":
        budget = 0.5 * c[first]
    else:
        assert counts[-1] == 1
        budget = c.sum() - 0.5 * c[last]
    q, flips, ok = bfrt.bfrt_select_plain(_t(r), _t(c), budget, rng=rr)
    assert bool(ok) and int(q) == (first if where == "bucket_0" else last)
    assert int(flips.sum()) == (0 if where == "bucket_0" else n - 1)
    _agree((q, flips, ok), bfrt.bfrt_sequential(r, c, budget))
    _agree(bfrt.bfrt_select_refined_plain(_t(r), _t(c), budget, rng=rr,
                                          cap=4),
           bfrt.bfrt_sequential(r, c, budget))


def test_budget_never_reached_and_no_eligible_column():
    r = np.array([0.5, np.inf, 0.25, 3.0])
    c = np.array([1.0, 0.0, 1.0, 1.0])
    _, _, ok = bfrt.bfrt_select_plain(_t(r), _t(c), 3.5)
    assert not bool(ok)
    q, flips, ok = bfrt.bfrt_select_plain(_t(r), _t(c), 2.5)
    assert bool(ok) and int(q) == 3
    assert flips.tolist() == [True, False, True, False]
    _, flips, ok = bfrt.bfrt_select_plain(_t(np.full(4, np.inf)),
                                          _t(np.zeros(4)), 0.0)
    assert not bool(ok) and not bool(flips.any())


@pytest.mark.parametrize("kind", KINDS + ["random"])
@pytest.mark.parametrize("cap", [1, 5, 64])
def test_refined_select_is_the_sequential_rule(kind, cap):
    """The kernel's crowded-bucket procedure, at caps that force one or
    several radix levels: the sequential rule's q, flips and has_cross."""
    rng = np.random.default_rng(cap + 7 * len(kind))
    n = 600
    if kind == "random":
        r = np.where(rng.random(n) < 0.5, rng.uniform(0, 10, n), np.inf)
        c = np.where(np.isfinite(r), rng.uniform(0.1, 2, n), 0.0)
        budgets = (0.42 * c.sum() + 0.003,)
    else:
        r, c, budgets = _case(kind, n, rng)
    rr = ratio_range_plain(_t(r))
    for budget in budgets:
        want = bfrt.bfrt_sequential(r, c, budget)
        got = bfrt.bfrt_select_refined_plain(_t(r), _t(c), budget, rng=rr,
                                             cap=cap)
        _agree(got, want)
        assert got[0].shape == () and got[2].shape == ()


def test_refined_select_without_a_crowded_bucket_is_the_plain_one():
    rng = np.random.default_rng(4)
    r, c, budgets = _case("ties", 500, rng)
    for budget in budgets:
        a = bfrt.bfrt_select_refined_plain(_t(r), _t(c), budget, cap=10_000)
        b = bfrt.bfrt_select_plain(_t(r), _t(c), budget)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_selector_on_the_cpu():
    """A Selector on the CPU runs the plain select, returns q and has_cross
    of shape (1,) (the pivot loop's indices), launches nothing, and checks
    its inputs as on the card."""
    n = 257
    rng = np.random.default_rng(6)
    r, c, budgets = _case("ties", n, rng)
    ratio, cost = _t(r), _t(c)
    select = bfrt.Selector(n, "cpu")
    before = bfrt.launches
    q, flips, ok = select(ratio, cost, torch.tensor([budgets[0]],
                                                    dtype=torch.float64),
                          rng=ratio_range_plain(ratio))
    assert bfrt.launches == before
    assert q.shape == (1,) and ok.shape == (1,) and flips.shape == (n,)
    _agree((q, flips, ok), bfrt.bfrt_sequential(r, c, budgets[0]))
    wq, wf, wok = bfrt.bfrt_select(ratio, cost, budgets[0])
    assert wq.shape == () and int(wq) == int(q)
    b = torch.ones(1, dtype=torch.float64)
    rr = ratio_range_plain(ratio)
    for bad in ((ratio.float(), cost, b, rr), (ratio[:-1], cost, b, rr),
                (ratio, cost[:-1], b, rr), (ratio[None], cost, b, rr),
                (torch.zeros(2 * n, dtype=torch.float64)[::2], cost, b, rr),
                (ratio, cost, b.repeat(2), rr),
                (ratio, cost, b.float(), rr), (ratio, cost, b, rr[:1]),
                (ratio, cost, b, rr.float())):
        with pytest.raises(ValueError):
            select(*bad[:3], rng=bad[3])
    with pytest.raises(ValueError):
        bfrt.Selector(0, "cpu")
