"""Pricing's range of the finite ratios and the BFRT edges built from it.

The pivot loop builds BFRT's bucket edges from the (min, max) of the
finite ratios that pricing writes (``bfrt.edges_from_range``) instead of
a pass over the ratios (``bfrt.bucket_edges``).  The edges must be the
same bit for bit, so that the select's q, flips and has_cross stay those
of the exact sequential rule; checked here on the CPU, where the plain
versions run, against the JAX package's pricing oracle and sequential
rule.  The kernel's own range is held to the plain one on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import bfrt, pricing

F64 = torch.float64


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _ratios(kind: str, n: int, rng) -> np.ndarray:
    r = np.where(rng.random(n) < 0.3, rng.uniform(0, 10, n), np.inf)
    if kind == "none":
        r[:] = np.inf
    elif kind == "zeros":
        r = np.where(np.isfinite(r), 0.0, r)
    elif kind == "one":
        r[:] = np.inf
        r[n // 2] = 3.25
    elif kind == "huge":
        r = np.where(np.isfinite(r), r * 1e300, r)
    return r


@pytest.mark.parametrize("kind", ["mixed", "none", "zeros", "one", "huge"])
@pytest.mark.parametrize("n", [1215, 100_004])
def test_edges_from_range_are_bucket_edges(kind, n):
    rng = np.random.default_rng(n)
    ratio = _t(_ratios(kind, n, rng))
    got = bfrt.edges_from_range(pricing.ratio_range_plain(ratio))
    want = bfrt.bucket_edges(ratio)
    assert got.shape == want.shape == (bfrt.NUM_BUCKETS,)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))


@pytest.mark.parametrize("m,n", [(4, 1215), (6, 5000)])
def test_pricing_range_and_select_match_the_reference(m, n):
    """Pricing's four outputs on the CPU: alpha, ratio and cost against the
    JAX oracle (1e-10, the reference test's bar), the range exactly that
    of the finite ratios, and the select from the range's edges equal to
    the reference's sequential rule."""
    rng = np.random.default_rng(m + n)
    A = rng.normal(size=(m, n))
    rho = rng.normal(size=m)
    d = np.abs(rng.normal(size=n))
    state = rng.integers(0, 3, n).astype(np.int32)
    lo, hi = np.zeros(n), rng.uniform(1, 3, n)
    for s in (1.0, -1.0):
        price = pricing.Pricer(_t(A), _t(lo), _t(hi))
        alpha, ratio, cost, rr = price(_t(rho), _t(d), _t(state, torch.int32),
                                       _t([s]))
        want = ref.pricing_ref(jnp.asarray(A), jnp.asarray(rho),
                               jnp.asarray(d), jnp.asarray(state),
                               jnp.asarray(lo), jnp.asarray(hi), s)
        for g, w in zip((alpha, ratio, cost), want):
            g, w = g.numpy(), np.asarray(w)
            np.testing.assert_allclose(np.where(np.isfinite(g), g, -1),
                                       np.where(np.isfinite(w), w, -1),
                                       rtol=1e-10, atol=1e-10)
        fin = ratio[torch.isfinite(ratio)]
        assert len(fin) > 0
        assert rr.tolist() == [float(fin.min()), float(fin.max())]
        r_np, c_np = ratio.numpy(), cost.numpy()
        for budget in (0.5, 10.0, 1e9):
            q, flips, ok = bfrt.bfrt_select(ratio, cost, budget, rng=rr)
            wq, wf, wok = ref.bfrt_sequential_ref(r_np, c_np, budget)
            assert bool(ok) == wok
            if wok:
                assert int(q) == wq
                np.testing.assert_array_equal(flips.numpy(), wf)


def test_pricing_is_one_pricer_call():
    """``pricing`` is a :class:`Pricer` built and called once: the same
    four outputs, bit for bit."""
    rng = np.random.default_rng(9)
    m, n = 3, 700
    A, lo, hi = _t(rng.normal(size=(m, n))), _t(np.zeros(n)), _t(np.ones(n))
    args = (_t(rng.normal(size=m)), _t(rng.normal(size=n)),
            _t(rng.integers(0, 3, n), torch.int32), -1.0)
    a = pricing.pricing(A, args[0], args[1], args[2], lo, hi, args[3])
    b = pricing.Pricer(A, lo, hi)(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
