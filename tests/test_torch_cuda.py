"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA card (decided inside the
fixture, never at import).  On the card run them with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports the JAX reference, which
this file does not need.)

Small shapes; ``chip_smoke.py`` repeats these checks at the main path's
shapes.  Tolerances: exact for counts, cuts, q and flip masks; 1e-12
relative for float64 sums and products summed in another order.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import bfrt, dlv_scan, pricing, segstats

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _t(a, dev, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pricing_kernel(dev, dtype):
    rng = np.random.default_rng(0)
    m, N = 4, 5003
    t = functools.partial(_t, dev=dev, dtype=dtype)
    args = (t(rng.normal(size=(m, N))), t(rng.normal(size=m)),
            t(rng.normal(size=N)), _t(rng.integers(0, 3, N), dev,
                                      torch.int32),
            t(np.zeros(N)), t(rng.uniform(1, 3, N)), -1.0)
    before = pricing.launches
    got = pricing.pricing(*args)
    torch.cuda.synchronize()
    assert pricing.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for g, w in zip(got, pricing.pricing_plain(*args)):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)


def test_bfrt_select_kernel(dev):
    rng = np.random.default_rng(1)
    N = 20_000
    r = np.where(rng.random(N) < 0.3, rng.uniform(0, 10, N), np.inf)
    c = np.where(np.isfinite(r), rng.uniform(0.1, 2, N), 0.0)
    for budget in (0.5, 100.0, 1e9):
        q, flips, ok = bfrt.bfrt_select(_t(r, dev), _t(c, dev), budget)
        wq, wf, wok = bfrt.bfrt_sequential(r, c, budget)
        assert bool(ok) == wok
        if wok:
            assert int(q) == wq
            np.testing.assert_array_equal(flips.cpu().numpy(), wf)


def test_segment_stats_kernel(dev):
    rng = np.random.default_rng(2)
    n, k, G = 50_000, 4, 300
    ids = _t(np.sort(rng.integers(0, G, n)), dev, torch.int64)
    vals = _t(rng.normal(size=(n, k)), dev)
    got = segstats.segment_stats(vals, ids, G)
    want = segstats.segment_stats_plain(vals, ids, G)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


def test_dlv_scan_kernel(dev):
    rng = np.random.default_rng(3)
    lens = np.array([20_000] + list(rng.integers(50, 400, 200)))
    parts = []
    for L in lens:
        v = np.sort(rng.normal(rng.uniform(-1e3, 1e3), 1.0, L))
        parts.append(v - v.mean())
    beta = np.array([13.5 * p.var() / 50 ** 2 for p in parts])
    vals = _t(np.concatenate(parts), dev)
    kernels.reset_launches()
    got = dlv_scan.dlv_scan(vals, lens, beta)
    assert kernels.launch_counts()["dlv_scan"] == 1
    assert torch.equal(got, dlv_scan.dlv_scan_plain(vals, lens, beta))
