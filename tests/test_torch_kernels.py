"""The port's kernel modules against the JAX reference, on the CPU.

On a CPU tensor every wrapper runs its plain torch version (the CUDA
kernels themselves are held against those on the card by
``chip_smoke.py``).  Inputs come from a seeded numpy generator and go
through both packages; the reference runs through its pure-jnp oracles
(``repro.kernels.ref``), its exact host twins and its host DLV scans, as
its own tests do.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dlv as ref_dlv
from repro.kernels import ref
from repro.kernels.segstats import segment_stats_np
from repro_torch import kernels
from repro_torch.core import dlv as port_dlv
from repro_torch.kernels import bfrt, dlv_scan, pricing, segstats

F64 = torch.float64


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# ------------------------------------------------------------- pricing


@pytest.mark.parametrize("m,n", [(3, 1000), (8, 3000), (1, 257), (16, 4096),
                                 (4, 100)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pricing_matches_reference_oracle(m, n, dtype):
    """Tolerance 1e-10 in float64 (the reference test's); 1e-3 in float32,
    where the dot product, summed in another order than the oracle's
    ``rho @ A``, carries float32 cancellation error into d / alpha."""
    rng = np.random.default_rng(m * 7919 + n)
    A = rng.normal(size=(m, n)).astype(dtype)
    rho = rng.normal(size=m).astype(dtype)
    d = rng.normal(size=n).astype(dtype)
    state = rng.integers(0, 3, n).astype(np.int32)
    lo = np.zeros(n, dtype)
    hi = rng.uniform(1, 3, n).astype(dtype)
    tdt = getattr(torch, dtype)
    tol = 1e-3 if dtype == "float32" else 1e-10
    before = pricing.launches
    for s in (1.0, -1.0):
        got = pricing.pricing(_t(A, tdt), _t(rho, tdt), _t(d, tdt),
                              _t(state, torch.int32), _t(lo, tdt),
                              _t(hi, tdt), s)
        want = ref.pricing_ref(jnp.asarray(A), jnp.asarray(rho),
                               jnp.asarray(d), jnp.asarray(state),
                               jnp.asarray(lo), jnp.asarray(hi), s)
        for g, w in zip(got, want):
            g, w = g.numpy(), np.asarray(w)
            assert g.dtype == w.dtype
            np.testing.assert_allclose(np.where(np.isfinite(g), g, -1),
                                       np.where(np.isfinite(w), w, -1),
                                       rtol=tol, atol=tol)
    assert pricing.launches == before      # CPU tensors never launch


# ---------------------------------------------------------------- BFRT


@pytest.mark.parametrize("n", [300, 2048, 5000])
@pytest.mark.parametrize("frac_elig", [0.05, 0.5])
def test_bfrt_select_is_the_sequential_rule(n, frac_elig):
    """Exact: the entering column, the flip mask and has_cross equal the
    reference's sequential walk (and the port's numpy copy of it)."""
    rng = np.random.default_rng(n + int(frac_elig * 100))
    ratio = np.where(rng.random(n) < frac_elig, rng.uniform(0, 10, n),
                     np.inf)
    cost = np.where(np.isfinite(ratio), rng.uniform(0.1, 2, n), 0.0)
    for budget in (0.5, 10.0, 100.0):
        q2, f2, ok2 = ref.bfrt_sequential_ref(ratio, cost, budget)
        q3, f3, ok3 = bfrt.bfrt_sequential(ratio, cost, budget)
        assert (q3, ok3) == (q2, ok2)
        np.testing.assert_array_equal(f3, f2)
        q1, f1, ok1 = bfrt.bfrt_select(_t(ratio), _t(cost), budget)
        assert bool(ok1) == ok2
        if ok2:
            assert int(q1) == q2
            np.testing.assert_array_equal(f1.numpy(), f2)


def test_bfrt_dual_unbounded():
    """Total flip capacity below the budget: no crossing."""
    rng = np.random.default_rng(11)
    n = 500
    ratio = np.where(rng.random(n) < 0.1, rng.uniform(0, 1, n), np.inf)
    cost = np.where(np.isfinite(ratio), 0.01, 0.0)
    _, _, ok = bfrt.bfrt_select(_t(ratio), _t(cost), 1e9)
    assert not bool(ok)


@pytest.mark.parametrize("n", [257, 4096])
def test_bfrt_histogram_matches_reference_oracle(n):
    """Counts exact; sums to 1e-5 relative because the reference oracle
    accumulates in float32 and the port in float64."""
    rng = np.random.default_rng(n)
    ratio = np.where(rng.random(n) < 0.4, rng.uniform(0, 5, n), np.inf)
    cost = np.where(np.isfinite(ratio), rng.uniform(0.1, 2, n), 0.0)
    edges = bfrt.bucket_edges(_t(ratio))
    sums, counts = bfrt.bfrt_histogram(_t(ratio), _t(cost), edges)
    s_ref, c_ref = ref.bfrt_histogram_ref(jnp.asarray(ratio),
                                          jnp.asarray(cost),
                                          jnp.asarray(edges.numpy()))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(c_ref))
    np.testing.assert_allclose(sums.numpy(), np.asarray(s_ref), rtol=1e-5,
                               atol=1e-5)
    assert float(counts.sum()) == np.isfinite(ratio).sum()


# -------------------------------------------------------- segment stats


@pytest.mark.parametrize("n,k,G", [(1000, 1, 11), (5000, 4, 57), (777, 2, 9),
                                   (3000, 4, 1)])
def test_segment_stats_matches_exact_host_twin(n, k, G):
    """Against the reference's exact float64 ``segment_stats_np``: counts
    exact, sums to 1e-12 relative (another summation order)."""
    rng = np.random.default_rng(n + k + G)
    ids = np.sort(rng.integers(0, G, n))
    vals = rng.normal(size=(n, k))
    got = segstats.segment_stats(_t(vals), _t(ids, torch.int64), G)
    want = segment_stats_np(vals, ids, G)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------- DLV scan


@pytest.mark.parametrize("lens", [[4000], [900] * 40, [17, 2500, 300, 41] * 8])
def test_seg_cuts_match_reference(lens):
    """Bit-equal cuts: the port's ``_seg_cuts`` (plain scan + run-start
    snapping) against the reference's host ``_seg_cuts`` and its per-segment
    float64 oracle, across the column and jump-scan paths."""
    rng = np.random.default_rng(8)
    segs = [np.sort(rng.normal(rng.uniform(-5, 5), 1.0, L)) for L in lens]
    beta = np.array([13.5 * max(np.var(s), 1e-12) / 60 ** 2 for s in segs])
    shifted = np.concatenate([s - s.mean() for s in segs])
    got = port_dlv._seg_cuts(_t(shifted), np.array(lens), beta).numpy()
    np.testing.assert_array_equal(
        got, ref_dlv._seg_cuts(shifted, np.array(lens), beta))
    want = np.concatenate([ref_dlv._dlv_scan_np(s - s.mean(), b)
                           for s, b in zip(segs, beta)])
    np.testing.assert_array_equal(got, want)


def test_scan_wide_magnitude_cut_parity():
    """The kernel's arithmetic (``scan_cols_plain``: compensated float64
    row steps) is bit-equal to the reference's float64 scans on the
    wide-magnitude, mean-centred values of the reference's own test."""
    for mag in (1e6, 3e7):
        for seed in range(3):
            rng = np.random.default_rng(seed)
            v = np.sort(rng.normal(mag, 1.0, 5000))
            beta = 13.5 * np.var(v) / 100 ** 2
            vc = v - v.mean()
            want = ref_dlv._dlv_scan_np(vc, beta)
            assert want.sum() > 10
            cols = dlv_scan.scan_cols_plain(_t(vc[:, None]),
                                            _t([beta]))[:, 0].numpy()
            np.testing.assert_array_equal(cols, want)
            np.testing.assert_array_equal(
                dlv_scan.dlv_scan(_t(vc), np.array([5000]),
                                  np.array([beta])).numpy(), want)
            jax64 = np.asarray(ref_dlv._dlv_scan_cols(
                jnp.asarray(vc[:, None]), jnp.asarray([beta])))[:, 0]
            np.testing.assert_array_equal(cols, jax64)


def test_scan_cols_bit_equal_to_reference_twin():
    """Many columns with their own bars: ``scan_cols_plain`` is the
    reference's ``_scan_cols_np`` operation for operation."""
    rng = np.random.default_rng(21)
    V = np.sort(rng.normal(size=(700, 33)), axis=0)
    V = V - V.mean(axis=0)
    B = 13.5 * V.var(axis=0) / rng.uniform(20, 200, 33) ** 2
    np.testing.assert_array_equal(
        dlv_scan.scan_cols_plain(_t(V), _t(B)).numpy(),
        ref_dlv._scan_cols_np(V, B))


def test_cpu_tensors_never_launch():
    """Every wrapper takes its plain version for a CPU tensor, and only a
    launch moves a counter."""
    kernels.reset_launches()
    rng = np.random.default_rng(5)
    v = _t(np.sort(rng.normal(size=300)))
    dlv_scan.dlv_scan(v - v.mean(), np.array([300]), np.array([1e-3]))
    segstats.segment_stats(_t(rng.normal(size=(50, 2))),
                           torch.zeros(50, dtype=torch.int64), 1)
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}
