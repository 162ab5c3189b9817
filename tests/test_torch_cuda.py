"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA card (decided inside the
fixture, never at import).  On the card run them with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports the JAX reference, which
this file does not need.)

Small shapes (segment stats at 1-3M rows, so that its adversarial
sortings span many tiles); ``chip_smoke.py`` repeats these checks at the
main path's shapes.  Tolerances: exact for counts, cuts, q and flip masks; 1e-12
relative for float64 sums and products summed in another order; flash
attention is held to the card check's bar, ``chip_smoke.flash_agreement``
(bfloat16: one bf16 ulp plus 1e-3 rms(plain) per element and a 5e-3
relative norm; float32: 2e-3 + 2e-3 |plain| and a 1e-4 relative norm).
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import attention, bfrt, dlv_scan, pricing, segstats

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
    want = pricing.pricing_plain(*args)
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)
    if dtype == torch.float32:
        assert got[3] is None        # the float32 route writes no range
    else:
        assert torch.equal(got[3], pricing.ratio_range_plain(got[1]))


@pytest.mark.parametrize("kind", ["mixed", "none", "zeros"])
def test_pricing_range_gives_the_bucket_edges(dev, kind):
    """The kernel's (min, max) of the finite ratios, and the edges built
    from it, bit-equal to the plain range and to ``bucket_edges(ratio)``,
    also with no eligible column (every column basic) and with every
    ratio 0; the select from those edges is the sequential rule."""
    rng = np.random.default_rng(7)
    m, N = 4, 100_004
    state = rng.integers(0, 3, N)
    if kind == "none":
        state[:] = 2
    d = np.abs(rng.normal(size=N)) * (kind != "zeros")
    args = (_t(rng.normal(size=(m, N)), dev), _t(rng.normal(size=m), dev),
            _t(d, dev), _t(state, dev, torch.int32), _t(np.zeros(N), dev),
            _t(rng.uniform(1, 3, N), dev), _t([-1.0], dev))
    _, ratio, cost, rr = pricing.pricing(*args)
    plain = pricing.ratio_range_plain(ratio)
    assert torch.equal(rr.isnan(), plain.isnan())
    assert torch.equal(rr.nan_to_num(), plain.nan_to_num())
    edges = bfrt.edges_from_range(rr)
    assert torch.equal(edges.view(torch.int64),
                       bfrt.bucket_edges(ratio).view(torch.int64))
    r, c = ratio.cpu().numpy(), cost.cpu().numpy()
    for budget in (0.5, 100.0, 1e9):
        q, flips, ok = bfrt.bfrt_select(ratio, cost, budget, rng=rr)
        wq, wf, wok = bfrt.bfrt_sequential(r, c, budget)
        assert bool(ok) == wok
        if wok:
            assert int(q) == wq
            np.testing.assert_array_equal(flips.cpu().numpy(), wf)


def test_pricer_checks_its_inputs(dev):
    """The loop constants are checked when the Pricer is made, the
    per-pivot inputs at every call: wrong ones raise."""
    m, N = 3, 100
    A = torch.zeros(m, N, dtype=torch.float64, device=dev)
    lo = hi = torch.zeros(N, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        pricing.Pricer(A, lo.float(), hi)
    with pytest.raises(ValueError):
        pricing.Pricer(A, lo[:-1], hi)
    with pytest.raises(ValueError):
        pricing.Pricer(A.t(), lo, hi)
    price = pricing.Pricer(A, lo, hi)
    rho, d = torch.zeros(m, dtype=torch.float64, device=dev), lo.clone()
    st = torch.zeros(N, dtype=torch.int32, device=dev)
    price(rho, d, st, -1.0)
    for bad in ((rho[:-1], d, st, -1.0), (rho, d.float(), st, -1.0),
                (rho, d.cpu(), st, -1.0), (rho, d, st.long(), -1.0),
                (rho, d, st, torch.ones(2, dtype=torch.float64,
                                        device=dev))):
        with pytest.raises((TypeError, ValueError)):
            price(*bad)


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


def _select_case(kind, N, rng):
    """(ratio, cost, budgets) of one kind: random, ties (five distinct
    ratios), all equal, an outlier that crowds the rest into bucket 0, no
    eligible column, or the crossing at that outlier in bucket 127 (with
    a range that stops short of it)."""
    c = rng.uniform(0.1, 2, N)
    if kind == "random":
        r = np.where(rng.random(N) < 0.3, rng.uniform(0, 10, N), np.inf)
    elif kind == "ties":
        r = np.where(rng.random(N) < 0.5, rng.integers(0, 5, N) * 1.0,
                     np.inf)
    elif kind == "all_equal":
        r = np.full(N, 2.5)
    elif kind in ("outlier", "bucket_127"):
        r = rng.uniform(0, 1, N)
        r[N // 2] = 1e6
    else:
        r = np.full(N, np.inf)
    c = np.where(np.isfinite(r), c, 0.0)
    tot = c.sum()
    if kind == "bucket_127":
        return r, c, (tot - 0.5 * c[N // 2],)
    return r, c, (0.5, 0.31 * tot + 0.0123, 0.77 * tot + 0.0071,
                  2 * tot + 1)


@pytest.mark.parametrize("N", [1215, bfrt.ONE_CTA_MAX, bfrt.ONE_CTA_MAX + 1,
                               100_004])
@pytest.mark.parametrize("kind", ["random", "ties", "all_equal", "outlier",
                                  "bucket_127", "none"])
def test_bfrt_selector_is_the_sequential_rule(dev, N, kind):
    """Both launch paths (one CTA up to ONE_CTA_MAX columns, the grid
    above), crowded buckets (above SELECT_CAP columns: the refinement)
    included: q, flips and has_cross equal the sequential rule and the
    kernel's torch mirror, and a second run is bit-identical."""
    rng = np.random.default_rng(N + len(kind))
    r, c, budgets = _select_case(kind, N, rng)
    ratio, cost = _t(r, dev), _t(c, dev)
    rr = pricing.ratio_range_plain(ratio)
    if kind == "bucket_127":           # a range short of the outlier
        rr = _t([r.min(), np.sort(r)[-2]], dev)
    select = bfrt.Selector(N, dev)
    for budget in budgets:
        b = _t([budget], dev)
        before = bfrt.launches
        q, flips, ok = (x.clone() for x in select(ratio, cost, b, rng=rr))
        assert bfrt.launches == before + (1 if N <= bfrt.ONE_CTA_MAX else 3)
        q2, flips2, ok2 = select(ratio, cost, b, rng=rr)
        assert torch.equal(q, q2) and torch.equal(flips, flips2) \
            and torch.equal(ok, ok2)
        wq, wf, wok = bfrt.bfrt_sequential(r, c, budget)
        assert bool(ok) == wok
        if wok:
            assert int(q) == wq
            np.testing.assert_array_equal(flips.cpu().numpy(), wf)
        mq, mf, mok = bfrt.bfrt_select_refined_plain(ratio, cost, budget,
                                                     rng=rr)
        assert int(q) == int(mq) and bool(ok) == bool(mok)
        assert torch.equal(flips, mf)


def test_bfrt_selector_reused_over_pivots(dev):
    """One Selector, 50 pivots of varied ratios, costs and budgets (the
    pivot loop's use), at the main path's N and above the one-CTA limit:
    each equals the sequential rule."""
    rng = np.random.default_rng(9)
    for N, pivots in ((1215, 50), (20_000, 10)):
        select = bfrt.Selector(N, dev)
        for i in range(pivots):
            frac = rng.uniform(0.05, 0.9)
            r = np.where(rng.random(N) < frac, rng.uniform(0, 10, N) ** 2,
                         np.inf)
            r[rng.random(N) < 0.1] = 0.0
            c = np.where(np.isfinite(r), rng.uniform(0.01, 3, N), 0.0)
            budget = rng.uniform(0, 1.2) * c.sum()
            ratio = _t(r, dev)
            q, flips, ok = select(ratio, _t(c, dev), _t([budget], dev),
                                  rng=pricing.ratio_range_plain(ratio))
            wq, wf, wok = bfrt.bfrt_sequential(r, c, budget)
            assert bool(ok) == wok, (N, i)
            if wok:
                assert int(q) == wq, (N, i)
                np.testing.assert_array_equal(flips.cpu().numpy(), wf)


def test_bfrt_selector_rejects_bad_inputs(dev):
    N = 300
    select = bfrt.Selector(N, dev)
    ratio = torch.zeros(N, dtype=torch.float64, device=dev)
    b = torch.ones(1, dtype=torch.float64, device=dev)
    rr = pricing.ratio_range_plain(ratio)
    select(ratio, ratio, b, rng=rr)
    for bad in ((ratio.float(), ratio, b, rr), (ratio[:-1], ratio, b, rr),
                (ratio.cpu(), ratio, b, rr), (ratio, ratio, b.repeat(2), rr),
                (ratio, ratio, b.cpu(), rr), (ratio, ratio, b, rr[:1]),
                (torch.zeros(2 * N, dtype=torch.float64, device=dev)[::2],
                 ratio, b, rr)):
        with pytest.raises(ValueError):
            select(*bad[:3], rng=bad[3])
    with pytest.raises(ValueError):
        bfrt.Selector(0, dev)
    with pytest.raises(ValueError):
        bfrt.Selector(N, dev, num_buckets=64)


@pytest.mark.parametrize("N, want", [(1215, 1), (100_004, 3)])
def test_bfrt_selector_is_its_kernels_alone(dev, N, want):
    """A Selector call issues the select's own launches and nothing else:
    no other kernel, copy or fill on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(4)
    r, c, _ = _select_case("random", N, rng)
    ratio, cost = _t(r, dev), _t(c, dev)
    rr = pricing.ratio_range_plain(ratio)
    b = _t([0.3 * c.sum()], dev)
    select = bfrt.Selector(N, dev)
    select(ratio, cost, b, rng=rr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        select(ratio, cost, b, rng=rr)
        torch.cuda.synchronize()
    names = {ev.key: ev.count for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA}
    assert names and all(k.split("(")[0].replace("void ", "")
                         .startswith("bfrt_") for k in names), names
    assert sum(names.values()) == want, names


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


@pytest.mark.parametrize("case, n", [
    ("G=1", 2_000_000), ("G=n", 1_000_003), ("gaps", 2_000_000),
    ("one group 95%", 3_000_000), ("tile edges", 1_500_000),
    ("skewed 231", 2_500_000), ("n < tile", 5_000)])
def test_segment_stats_kernel_is_its_mirror(dev, case, n):
    """Adversarial sortings (``chip_smoke.segstats_case``: one group, every
    row its own group, empty groups and gaps at both ends, one group of
    95% of the rows, every group ending on a tile edge, 231 groups with
    one of 476,724 rows, fewer rows than a tile): the kernel bit-equal to
    ``segment_stats_tiled_plain`` at its own tile and to a second run,
    and within ``chip_smoke.segstats_check``'s bars of the plain version
    (counts exact, sums 1e-12 of the group's |v| mass, sums of squares
    1e-12 relative)."""
    cs = _chip_smoke()
    vals, ids, G = cs.segstats_case(np.random.default_rng(11), case, n, dev)
    before = segstats.launches
    got = segstats.segment_stats(vals, ids, G)
    assert segstats.launches == before + 2
    want = segstats.segment_stats_tiled_plain(vals, ids, G)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    cs.segstats_check(vals, ids, G)


@pytest.mark.parametrize("k", range(1, segstats.MAX_K + 1))
@pytest.mark.parametrize("steps", [1, 3])
def test_segment_stats_kernel_every_k_and_tile(dev, k, steps):
    """Every k, at a tile of one step and of three: bit-equal to the
    mirror at that tile, empty groups zero."""
    rng = np.random.default_rng(k * 10 + steps)
    n, G = 300_001, 40_000
    ids = np.sort(rng.integers(5, G - 5, n))
    vals = _t(rng.normal(size=(n, k)), dev)
    tile = steps * segstats.step_rows(k)
    got = segstats.segment_stats(vals, _t(ids, dev, torch.int64), G,
                                 tile=tile)
    want = segstats.segment_stats_tiled_plain(
        vals, _t(ids, dev, torch.int64), G, tile=tile)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    empty = np.setdiff1d(np.arange(G), ids)
    assert len(empty) and not bool(got[0][_t(empty, dev, torch.int64)]
                                   .any())


def test_segment_stats_is_its_two_kernels_alone(dev):
    """A call issues the tile pass and the carry merge, and no other
    kernel, copy or fill on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cs = _chip_smoke()
    vals, ids, G = cs.segstats_case(np.random.default_rng(12), "skewed 231",
                                    1_000_000, dev)
    segstats.segment_stats(vals, ids, G)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        segstats.segment_stats(vals, ids, G)
        torch.cuda.synchronize()
    names = {ev.key.split("(")[0].replace("void ", ""): ev.count
             for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA}
    assert sorted(k.split("<")[0] for k in names) == [
        "segstats_merge", "segstats_tiles"], names
    assert sum(names.values()) == 2, names


def test_segment_stats_rejects_bad_inputs(dev):
    vals = torch.zeros((100, 4), dtype=torch.float64, device=dev)
    ids = torch.zeros(100, dtype=torch.int64, device=dev)
    for bad in (dict(vals=vals.float()), dict(vals=vals[:, :2].t()),
                dict(vals=torch.zeros((100, 9), dtype=torch.float64,
                                      device=dev)),
                dict(ids=ids.int()), dict(ids=ids[:50]),
                dict(tile=segstats.step_rows(4) + 1), dict(tile=0)):
        args = dict(vals=vals, ids=ids, num_groups=3) | bad
        with pytest.raises(ValueError):
            segstats.segment_stats(**args)
    got = segstats.segment_stats(vals[:0], ids[:0], 3)
    assert all(not bool(t.any()) for t in got)


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


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flash_agreement():
    return _chip_smoke().flash_agreement


def test_dlv_scan_long_and_short_segments(dev):
    """Segments on both sides of ``LONG_MIN``: one of 1.2M rows, 200 of
    about 43k (round 2 of the 10M build) and 300 short ones, in one call
    (one launch).  Cuts bit-equal to ``dlv_scan_plain``; every window
    between cuts, whole, cuts by ``scan_cols_plain`` at its last row and
    nowhere before (``chip_smoke.row_step_check``); the long path ran."""
    rng = np.random.default_rng(4)
    lens = np.concatenate([[1_200_000], rng.integers(40_000, 46_000, 200),
                           rng.integers(50, 3000, 300)])
    rng.shuffle(lens)
    cs = _chip_smoke()
    v, beta = cs._segments(rng, lens)
    vals = _t(v, dev)
    kernels.reset_launches()
    got, st = dlv_scan.dlv_scan(vals, lens, beta, pitch=100, stats=True)
    assert kernels.launch_counts()["dlv_scan"] == 1
    stats = dict(zip(dlv_scan.STAT_NAMES, st.tolist()))
    assert stats["segments"] == int((lens >= dlv_scan.LONG_MIN).sum())
    assert torch.equal(got, dlv_scan.dlv_scan_plain(vals, lens, beta,
                                                    pitch=100))
    cs.row_step_check(vals, lens, beta, got, whole=True)


def _comp_scan_np(v, beta):
    """The compensated scan with restarts, row by row in numpy floats (the
    reference's ``_scan_cols_np`` for one column); also returns the running
    variance at every row."""
    k = s1 = c1 = s2 = c2 = 0.0
    cuts, var = np.zeros(len(v), bool), np.empty(len(v))
    for i, x in enumerate(v):
        k1 = k + 1.0
        x2 = x * x
        y1 = x - c1
        t1 = s1 + y1
        c1n = (t1 - s1) - y1
        y2 = x2 - c2
        t2 = s2 + y2
        c2n = (t2 - s2) - y2
        mean = t1 / k1
        var[i] = t2 / k1 - mean * mean
        if var[i] > beta and k > 0:
            cuts[i] = True
            k, s1, c1, s2, c2 = 1.0, x, 0.0, x2, 0.0
        else:
            k, s1, c1, s2, c2 = k1, t1, c1n, t2, c2n
    return cuts, var


def test_dlv_long_path_near_ties(dev, monkeypatch):
    """beta set to the compensated running variance of a row (and one ulp
    to each side), so that the long path's verify meets values within
    rounding of the bar, where its product-form test defers to the
    division form: the cuts are the compensated scan's."""
    rng = np.random.default_rng(8)
    v = np.sort(rng.lognormal(0.0, 0.55, 20_000))
    v = v - v.mean()
    _, var = _comp_scan_np(v, np.inf)
    vals = _t(v, dev)
    monkeypatch.setattr(dlv_scan, "LONG_MIN", 1)
    for r in (40, 300, 2_000, 9_000, 19_000):
        for beta in (var[r], np.nextafter(var[r], np.inf),
                     np.nextafter(var[r], -np.inf)):
            got = dlv_scan.dlv_scan(vals, np.array([len(v)]),
                                    np.array([beta]))
            want, _ = _comp_scan_np(v, beta)
            np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_dlv_verify_entry_repairs_a_wrong_guess(dev):
    """The long path launched directly with a wrong speculative list (cuts
    shifted, missing, added): it returns the compensated cuts, through
    repairs."""
    rng = np.random.default_rng(6)
    v = np.sort(rng.lognormal(0.0, 0.55, 60_000))
    v = v - v.mean()
    beta = 13.5 * v.var() / 100 ** 2
    want = dlv_scan.scan_cols_plain(_t(v[:, None], dev),
                                    _t([beta], dev))[:, 0]
    true = np.flatnonzero(want.cpu().numpy())
    assert len(true) > 10
    for spec in (true + 1, true[::2], np.union1d(true, true[:-1] + 3),
                 np.zeros(0, np.int64)):
        spec = spec[(spec >= 1) & (spec < len(v))]
        cuts, st = dlv_scan.verify_speculation(_t(v, dev), beta, spec)
        assert torch.equal(cuts, want)
        if len(spec):
            assert int(st[dlv_scan.STAT_NAMES.index("repairs")]) >= 1


def _seed_running_vars(v, beta):
    """The seed scan's running variance at every row, with its restarts,
    rounded as the reference's compiled scan rounds (one fused
    multiply-add in the variance; exact rationals here)."""
    from fractions import Fraction
    k = s1 = s2 = 0.0
    out = []
    for x in v:
        k1 = k + 1.0
        s1n, s2n = s1 + x, s2 + x * x
        m = s1n / k1
        var = float(Fraction(s2n / k1) - Fraction(m) * Fraction(m))
        out.append(var)
        k, s1, s2 = (1.0, x, x * x) if var > beta else (k1, s1n, s2n)
    return out


@pytest.mark.parametrize("L", [1, 2, 15, 16, 17, 1000, 100_000])
def test_dlv_scan_seed_kernel(dev, L):
    """The seed scan's kernel: cuts bit-equal to ``dlv_scan_seed_plain``
    at span lengths across its 16-row register batches, one launch a
    call, and a bool tensor on the card."""
    rng = np.random.default_rng(L)
    v = np.sort(rng.normal(rng.uniform(-1e3, 1e3), 2.0, L))
    v = v - v.mean()
    beta = 13.5 * v.var() / 30 ** 2 if L > 1 else 0.0
    vals = _t(v, dev)
    kernels.reset_launches()
    got = dlv_scan.dlv_scan_seed(vals, beta)
    assert kernels.launch_counts()["dlv_scan_seed"] == 1
    assert got.device.type == "cuda" and got.dtype == torch.bool
    want = dlv_scan.dlv_scan_seed_plain(vals.cpu(), beta)
    assert torch.equal(got.cpu(), want)
    if L >= 1000:
        assert int(want.sum()) > 10


def test_dlv_scan_seed_kernel_near_ties(dev):
    """beta at a running variance of the seed scan and one ulp to each
    side: the kernel rounds as the plain version does (the variance's one
    FMA, every other operation on its own), so the cuts are equal."""
    rng = np.random.default_rng(9)
    v = np.sort(rng.lognormal(0.0, 0.55, 5_000))
    v = v - v.mean()
    vals = _t(v, dev)
    b0 = 13.5 * v.var() / 40 ** 2
    var = _seed_running_vars(v, b0)
    for r in (3, 40, 700, 2_500, 4_999):
        for beta in (var[r], np.nextafter(var[r], np.inf),
                     np.nextafter(var[r], -np.inf)):
            got = dlv_scan.dlv_scan_seed(vals, beta)
            want = dlv_scan.dlv_scan_seed_plain(vals.cpu(), beta)
            assert torch.equal(got.cpu(), want), (r, beta)


def test_dlv_scan_seed_rejects_bad_inputs(dev):
    v = _t(np.arange(10.0), dev)
    for bad in (v.float(), v[::2], v.reshape(2, 5)):
        with pytest.raises(ValueError):
            dlv_scan.dlv_scan_seed(bad, 1.0)
    assert dlv_scan.dlv_scan_seed(v[:0], 1.0).shape == (0,)


def test_heap_build_on_the_card_equals_the_cpu(dev):
    """``dlv_heap`` with each pop's scan on the card (``scan="fast"``: the
    DLV scan kernel; ``"seed"``: the seed kernel) gives the CPU build's
    partition, and the descent agrees with gid."""
    from repro_torch.core.dlv import dlv_heap
    rng = np.random.default_rng(7)
    X = np.concatenate([rng.normal(0, 1, (3000, 3)),
                        rng.normal(7, 2, (3000, 3))]) * [1.0, 4.0, 0.3]
    for scan in ("fast", "seed"):
        kernels.reset_launches()
        got = dlv_heap(X, 40, scan=scan, device=dev)
        counts = kernels.launch_counts()
        want = dlv_heap(X, 40, scan=scan, device="cpu")
        if scan == "seed":
            assert counts["dlv_scan_seed"] >= got.tree.num_nodes
        for f in ("order", "offsets", "gid"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        np.testing.assert_array_equal(got.tree.bounds, want.tree.bounds)
        np.testing.assert_array_equal(
            got.get_group_batch(X, jit=True, device=dev), got.gid)


@pytest.mark.parametrize("S", [1, 64, 65, 127, 128, 129, 200])
@pytest.mark.parametrize("H,KV", [(6, 2), (12, 2)])
@pytest.mark.parametrize("d", [64, 120, 128])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 70),
                                           (False, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(dev, S, H, KV, d, causal, window, dtype):
    """Kernel vs plain scan at S on both sides of the tile edges (64-key
    tiles, 64- and 128-row query tiles) and at a ragged S, with the GQA
    groups of 3 and of qwen2's 6, held to the card check's bar."""
    rng = np.random.default_rng(d + window + S)
    B = 2
    q, k, v = (_t(rng.normal(size=(B, S, h, d)), dev, torch.float32)
               .to(dtype) for h in (H, KV, KV))
    before = attention.launches
    got = attention.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    want = attention.flash_attention_plain(q, k, v, causal=causal,
                                           window=window)
    assert bool(torch.isfinite(got).all())
    err, over, rel, ok = _flash_agreement()(got, want)
    assert ok, (f"max abs err {err}, {over} of the elementwise limit, "
                f"relative norm {rel}")


def test_chunked_attention_outside_the_kernel_raises(dev):
    from repro_torch.models.attention import chunked_attention
    q = torch.zeros(1, 64, 4, 64, device=dev)
    k = v = torch.zeros(1, 64, 2, 64, device=dev)
    pos = torch.arange(64, device=dev)
    for kw in (dict(prefix_len=8), dict(scale=0.5)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            chunked_attention(q, k, v, pos, pos, causal=True, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        chunked_attention(q, k, v, pos, pos.clone(), causal=False)
    with pytest.raises(ValueError):
        attention.flash_attention(q[..., :32].contiguous(),
                                  k[..., :32].contiguous(),
                                  v[..., :32].contiguous())


def test_model_prefill_goes_through_the_kernel(dev):
    """A two-layer model with head_dim 64: prefill on the card launches the
    kernel once per layer and agrees with 12 decode steps (2e-3)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config("qwen2-1.5b").smoke(),
                              head_dim=64, param_dtype="float32")
    model = Model(cfg, device=dev).init(seed=0)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 12)), device=dev)
    before = attention.launches
    full = model.prefill_logits({"tokens": toks})
    assert attention.launches == before + cfg.num_layers
    cache = model.init_cache(2, 16)
    for t in range(12):
        logits, cache = model.decode_step(cache, toks[:, t:t + 1])
        torch.testing.assert_close(logits, full[:, t], rtol=2e-3, atol=2e-3)


# ------------------------------------------- the batched LP engine (lp_batch)


def _lp_instance(seed, n, width):
    """The reference benchmark's gift-basket table
    (``benchmarks/batch_lp.py::_instance``)."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(14.0, 1.5, n)
    c = np.abs(rng.normal(1.0, 0.5, n))
    return (c, np.vstack([np.ones(n), vals]), np.array([15.0, 420.0 - width]),
            np.array([45.0, 420.0 + width]))


def _rungs(n, R=12, q=25.0):
    """The Dual Reducer's rung flight of ``benchmarks/batch_lp.py``:
    ``ub`` caps E / (q 2^j) of one (c, A), warm from lp1."""
    from repro_torch.core.lp import solve_lp_np
    c, A, bl, bu = _lp_instance(9, n, 2.0)
    ub = np.full(n, 3.0)
    lp1 = solve_lp_np(c, A, bl, bu, ub)
    E = float(np.sum(lp1.x))
    return c, A, bl, bu, [np.minimum(ub, max(E / (q * 2 ** j), 1e-9))
                          for j in range(R)], lp1


def _lane_bar(got, want):
    from repro_torch.core.lp import OPTIMAL
    for k, (g, w) in enumerate(zip(got, want)):
        assert (g.status, g.iters) == (w.status, w.iters), k
        if w.status == OPTIMAL:
            assert abs(g.obj - w.obj) <= 1e-9, k
            assert np.array_equal(np.sort(g.basis), np.sort(w.basis)), k
            assert np.array_equal(g.at_upper, w.at_upper), k
            assert np.abs(g.x - w.x).max() <= 1e-9, k


@pytest.mark.parametrize("n", [300, 5000])
def test_lp_batch_rung_flight(dev, n):
    """The rung flight (n = 300, and 5,000 columns: past the kernel's
    2,048 shared-memory columns (``NS_MAX`` in ``csrc/lp_batch.cu``), a
    lane's state in the global workspace) in one launch, lane for lane the
    plain version and ``solve_lp_np`` (the reference's lane bar)."""
    from repro_torch.core.lp_batch import solve_lp_batch
    from repro_torch.kernels import lp_batch
    c, A, bl, bu, ubs, lp1 = _rungs(n)
    kw = dict(warm_starts=[lp1] * len(ubs))
    before = lp_batch.launches
    got = solve_lp_batch(c, A, bl, bu, ubs, backend="device", device=dev,
                         **kw)
    assert lp_batch.launches == before + 1
    _lane_bar(got, solve_lp_batch(c, A, bl, bu, ubs, backend="device",
                                  device="cpu", **kw))
    _lane_bar(got, solve_lp_batch(c, A, bl, bu, ubs, backend="np", **kw))


@pytest.mark.parametrize("m", [3, 7, 13, 20, 40, 100])
def test_lp_batch_every_row_class(dev, m):
    """Random flights at m_pad = 4, 8, 16 and 32 (rows in shared memory)
    and 64 and 128 (rows in the global workspace), cold: kernel = plain."""
    from repro_torch.core.lp_batch import solve_lp_batch
    for seed in range(4):
        rng = np.random.default_rng(seed)
        n = max(40, 2 * m)
        c, A = rng.normal(size=n), rng.normal(size=(m, n))
        ub = rng.integers(1, 4, size=n).astype(float)
        act = A @ (rng.uniform(0, 1, n) * ub)
        wid = np.abs(rng.normal(size=m)) * 2 + 0.5
        ubs = [ub * rng.uniform(0.5, 1.0, n) for _ in range(6)]
        got = solve_lp_batch(c, A, act - wid, act + wid, ubs,
                             backend="device", device=dev)
        _lane_bar(got, solve_lp_batch(c, A, act - wid, act + wid, ubs,
                                      backend="device", device="cpu"))


def test_lp_batch_bnb_instance(dev):
    """B&B at W = 64 on the reference benchmark's instance: the card's
    waves give the plain version's search (nodes, LP iterations) and the
    node loop's package and objective."""
    from repro_torch.core.ilp import solve_ilp
    from repro_torch.kernels import lp_batch
    c, A, bl, bu = _lp_instance(42, 150, 0.05)
    ub = np.ones(150)
    kw = dict(max_nodes=50_000, time_limit_s=600)
    before = lp_batch.launches
    got = solve_ilp(c, A, bl, bu, ub, wave_width=64, device=dev, **kw)
    assert lp_batch.launches > before
    plain = solve_ilp(c, A, bl, bu, ub, wave_width=64, device="cpu", **kw)
    one = solve_ilp(c, A, bl, bu, ub, wave_width=1, device="cpu", **kw)
    assert (got.nodes, got.lp_iters) == (plain.nodes, plain.lp_iters)
    assert np.array_equal(got.x, one.x) and got.obj == one.obj


def test_lp_batch_shared_budget_truncates_mid_flight(dev):
    """A shared pivot cap that stops the lockstep loop mid-flight: two
    launches, and every lane's status, iterations and notes equal the
    plain version's lockstep loop."""
    from repro_torch.core.guard import SolveBudget
    from repro_torch.core.lp_batch import solve_lp_batch
    from repro_torch.kernels import lp_batch
    rng = np.random.default_rng(3)
    n, m = 60, 5
    c, A = rng.normal(size=n), rng.normal(size=(m, n))
    ub = rng.integers(1, 4, size=n).astype(float)
    act = A @ (rng.uniform(0, 1, n) * ub)
    wid = np.abs(rng.normal(size=m)) * 2 + 0.5
    ubs = [ub * rng.uniform(0.5, 1.0, n) for _ in range(8)]
    args = (c, A, act - wid, act + wid, ubs)
    its = [r.iters for r in solve_lp_batch(*args, backend="device",
                                           device="cpu")]
    cap = int(np.minimum(its, int(np.median(its))).sum())
    before = lp_batch.launches
    got = solve_lp_batch(*args, backend="device", device=dev,
                         budget=SolveBudget(max_pivots=cap))
    want = solve_lp_batch(*args, backend="device", device="cpu",
                          budget=SolveBudget(max_pivots=cap))
    assert [(g.status, g.iters, g.notes) for g in got] == \
        [(w.status, w.iters, w.notes) for w in want]
    assert lp_batch.launches == before + 2


def test_lp_batch_kernel_and_plain_on_the_card(dev):
    """One ``LaneSolver`` call against ``lp_batch_plain`` on the same card
    tensors (out packs held lane by lane, ``lane_mismatches``)."""
    from repro_torch.core import lp_batch as core
    from repro_torch.kernels import lp_batch
    c, A, bl, bu, ubs, lp1 = _rungs(300)
    kept = []
    saved = lp_batch.LaneSolver.__call__

    def keep(self, cf, Ad, in_pack):
        kept.append((self, cf, Ad, in_pack.copy()))
        return saved(self, cf, Ad, in_pack)

    lp_batch.LaneSolver.__call__ = keep
    try:
        core.solve_lp_batch(c, A, bl, bu, ubs, warm_starts=[lp1] * len(ubs),
                            backend="device", device=dev)
    finally:
        lp_batch.LaneSolver.__call__ = saved
    (solver, cf, Ad, in_pack), = kept
    got = solver(cf, Ad, in_pack)
    want = lp_batch.lp_batch_plain(
        cf, Ad, torch.as_tensor(in_pack, device=dev),
        max_iters=solver.max_iters,
        refactor_every=solver.refactor_every).cpu().numpy()
    bad, _, _ = lp_batch.lane_mismatches(got, want, in_pack, solver.m_pad)
    assert not bad, bad
    with pytest.raises(ValueError):
        solver(cf, Ad, in_pack[:, :-1])


def _one_flight(dev, *args, **kw):
    """The (solver, cf, A, in pack) of one ``solve_lp_batch`` flight on
    the card, and the out pack the kernel gave."""
    from repro_torch.core.lp_batch import solve_lp_batch
    from repro_torch.kernels import lp_batch
    kept = []
    saved = lp_batch.LaneSolver.__call__

    def keep(self, cf, Ad, in_pack):
        out = saved(self, cf, Ad, in_pack)
        kept.append((self, cf, Ad, in_pack.copy(), out.copy()))
        return out

    lp_batch.LaneSolver.__call__ = keep
    try:
        solve_lp_batch(*args, backend="device", device=dev, **kw)
    finally:
        lp_batch.LaneSolver.__call__ = saved
    (flight,) = kept
    return flight


def _plain_pack(solver, cf, Ad, in_pack):
    from repro_torch.kernels import lp_batch
    return lp_batch.lp_batch_plain(
        cf, Ad, torch.as_tensor(in_pack, device=cf.device),
        max_iters=solver.max_iters,
        refactor_every=solver.refactor_every).cpu().numpy()


def test_lp_batch_nan_cost(dev):
    """A NaN in c gives NaN reduced costs, so NaN ratios among the
    eligible breakpoints: the kernel sorts them last, as the plain version
    does (it neither drops them nor spins), and its lanes equal the plain
    version's (status, iterations, basis, bound pattern exact; x within
    1e-9, NaN where the plain version has NaN)."""
    rng = np.random.default_rng(4)
    n, m = 40, 4
    c, A = rng.normal(size=n), rng.normal(size=(m, n))
    c[[5, 17]] = np.nan
    ub = rng.integers(1, 4, size=n).astype(float)
    act = A @ (rng.uniform(0, 1, n) * ub)
    wid = np.abs(rng.normal(size=m)) * 2 + 0.5
    ubs = [ub * rng.uniform(0.5, 1.0, n) for _ in range(6)]
    solver, cf, Ad, in_pack, got = _one_flight(dev, c, A, act - wid,
                                               act + wid, ubs)
    want = _plain_pack(solver, cf, Ad, in_pack)
    N, mp = solver.N, solver.m_pad
    o = N + mp
    for k in range(len(ubs)):
        g, w = got[k], want[k]
        assert np.array_equal(g[o + 1 + mp:o + 3 + mp],
                              w[o + 1 + mp:o + 3 + mp]), k
        assert np.array_equal(np.sort(g[o + 1:o + 1 + mp]),
                              np.sort(w[o + 1:o + 1 + mp])), k
        assert np.array_equal(g[o + 5 + mp:o + 5 + mp + N],
                              w[o + 5 + mp:o + 5 + mp + N]), k
        np.testing.assert_allclose(g[:N], w[:N], rtol=0, atol=1e-9,
                                   equal_nan=True)


def test_lp_batch_threads_share_one_class(dev):
    """Four threads dispatch flights of one shape class on the card at
    once through one cached LaneSolver: each gets its own flight's lanes,
    equal to that flight solved alone and to the plain version."""
    from repro_torch.core.lp_batch import solve_lp_batch
    from repro_torch.runtime.racecheck import run_threads

    def flight(seed):
        rng = np.random.default_rng(seed)
        n, m = 60, 5
        c, A = rng.normal(size=n), rng.normal(size=(m, n))
        ub = rng.integers(1, 4, size=n).astype(float)
        act = A @ (rng.uniform(0, 1, n) * ub)
        wid = np.abs(rng.normal(size=m)) * 2 + 0.5
        return (c, A, act - wid, act + wid,
                [ub * rng.uniform(0.5, 1.0, n) for _ in range(8)])

    seeds = range(4)
    alone = {s: solve_lp_batch(*flight(s), backend="device", device=dev)
             for s in seeds}
    for s in seeds:
        _lane_bar(alone[s], solve_lp_batch(*flight(s), backend="device",
                                           device="cpu"))
    runs = run_threads([
        (lambda s=s: [solve_lp_batch(*flight(s), backend="device",
                                     device=dev) for _ in range(5)])
        for s in seeds])
    for s, got in zip(seeds, runs):
        for g in got:
            assert [(r.status, r.iters) for r in g] == \
                [(r.status, r.iters) for r in alone[s]]
            for r, a in zip(g, alone[s]):
                assert r.obj == a.obj and np.array_equal(r.x, a.x)


# the batched LP engine's two paths: one warp a lane for m_pad <= 32 and
# N <= WARP_N_MAX, one CTA a lane for the rest


def _lp_define(name):
    """A compile-time constant of ``csrc/lp_batch.cu``."""
    import re
    src = Path(__file__).resolve().parents[1] / \
        "src/repro_torch/csrc/lp_batch.cu"
    return int(re.search(rf"#define {name} (\d+)", src.read_text())[1])


def _warp_n_max():
    return _lp_define("WARP_N_MAX")


def _cta_lib():
    """The kernel built with WARP_N_MAX 0: every flight on the CTA path."""
    from repro_torch.kernels import _build, lp_batch
    return _build.load_variant("lp_batch", lp_batch._SIG,
                               ("-DWARP_N_MAX=0",))


def _on_cta(solver, lib=None):
    """A new LaneSolver of ``solver``'s class bound to the WARP_N_MAX 0
    build (``lib``, else built here); ``solver`` itself may be the
    engine's cached one, which must keep the source's kernel."""
    from repro_torch.kernels import lp_batch
    other = lp_batch.LaneSolver(solver.m_pad, solver.n_pad, solver.K_pad,
                                solver.max_iters, solver.refactor_every,
                                solver.device)
    other._bind(_cta_lib() if lib is None else lib)
    assert other.plan["path"] == "cta"
    return other


def _cold_flight(dev, seed, m, n, n_pad, m_pad, K, nan_cost=False):
    """A cold in pack of K bound variants of one random (c, A), laid out as
    ``core/lp_batch.py::_dispatch`` lays it out (any ``n_pad``, so any
    N), with the LaneSolver of its class and (cf, A) on the card."""
    from repro_torch.kernels import lp_batch
    rng = np.random.default_rng(seed)
    c, At = rng.normal(size=n), rng.normal(size=(m, n))
    if nan_cost:
        c[[1, n // 2]] = np.nan
    ub = rng.integers(1, 4, size=n).astype(float)
    act = At @ (rng.uniform(0, 1, n) * ub)
    wid = np.abs(rng.normal(size=m)) * 2 + 0.5
    N = n_pad + m_pad
    cf = np.zeros(N)
    cf[:n] = c
    A = np.zeros((m_pad, N))
    A[:m, :n] = -At
    A[:, n_pad:] = np.eye(m_pad)
    pack = np.zeros((K, lp_batch.in_width(N, m_pad)))
    pack[:, :n] = 0.0
    pack[:, N:N + n] = [ub * rng.uniform(0.5, 1.0, n) for _ in range(K)]
    pack[:, n_pad:n_pad + m] = act - wid
    pack[:, N + n_pad:N + n_pad + m] = act + wid
    pack[:, 2 * N] = 1e-7
    pack[:, 2 * N + 1:2 * N + 1 + m_pad] = np.arange(n_pad, N)
    pack[:, 2 * N + 1 + m_pad:2 * N + 1 + m_pad + n] = c < 0
    pack[:, 3 * N + 1 + m_pad] = 1.0
    pack[0, 3 * N + 2 + m_pad] = K * 500
    solver = lp_batch.LaneSolver(m_pad, n_pad, K, 500, 64, dev)
    return (solver, torch.as_tensor(cf, device=dev),
            torch.as_tensor(A, device=dev), pack)


def _hold_to_plain(solver, cf, Ad, pack, got=None):
    from repro_torch.kernels import lp_batch
    got = solver(cf, Ad, pack) if got is None else got
    want = _plain_pack(solver, cf, Ad, pack)
    bad, _, _ = lp_batch.lane_mismatches(got, want, pack, solver.m_pad)
    assert not bad, bad
    col = 2 * solver.N + 2 * solver.m_pad + 5
    assert got[0, col] == want[0, col]
    return got


def test_lp_batch_plan_picks_the_path(dev):
    """The kernel's plan: m_pad <= 32 and N <= WARP_N_MAX on the warp path,
    up to WARP_LANES_MAX lanes a CTA (as many as K and the shared budget
    allow), (cf, A) staged when it fits beside them; wider or taller on
    the CTA path."""
    from repro_torch.kernels import lp_batch
    wn, most = _warp_n_max(), _lp_define("WARP_LANES_MAX")
    plan = lambda m, n, K: lp_batch.LaneSolver(    # noqa: E731
        m, n, K, 100, 64, dev).plan
    p = plan(4, 160, 128)
    assert (p["path"], p["lanes_per_cta"], p["staged"]) == \
        ("warp", most, True)
    assert plan(4, 160, 1)["lanes_per_cta"] == 1
    assert plan(32, wn - 32, 8)["path"] == "warp"
    assert plan(32, wn - 31, 8)["path"] == "cta"
    assert plan(64, 60, 8)["path"] == "cta"
    assert plan(4, 100_000, 4)["path"] == "cta"
    p = plan(32, wn - 32, 8)
    assert not p["staged"] and p["lanes_per_cta"] < most


@pytest.mark.parametrize("extra", [0, 1])
def test_lp_batch_n_at_the_warp_limit(dev, extra):
    """N = WARP_N_MAX (the warp path) and WARP_N_MAX + 1 (the CTA path):
    each lane equals the plain version on the card."""
    wn = _warp_n_max()
    flight = _cold_flight(dev, 11, 6, wn - 40, wn - 8 + extra, 8, 6)
    assert flight[0].plan["path"] == ("warp" if extra == 0 else "cta")
    _hold_to_plain(*flight)


@pytest.mark.parametrize("K", [1, 7, 9, 129])
def test_lp_batch_lanes_not_a_multiple_of_the_cta(dev, K):
    """Flights of 1, 7, 9 and 129 lanes: through ``solve_lp_batch`` (K_pad
    4, 8, 12, 132: padded lanes) every lane equals the plain version and
    ``solve_lp_np``; and as a LaneSolver of exactly K lanes (the last CTA
    with warps past K_pad) the plain version."""
    from repro_torch.core.lp_batch import solve_lp_batch
    rng = np.random.default_rng(K)
    n, m = 60, 5
    c, A = rng.normal(size=n), rng.normal(size=(m, n))
    ub = rng.integers(1, 4, size=n).astype(float)
    act = A @ (rng.uniform(0, 1, n) * ub)
    wid = np.abs(rng.normal(size=m)) * 2 + 0.5
    ubs = [ub * rng.uniform(0.5, 1.0, n) for _ in range(K)]
    solver, cf, Ad, pack, got = _one_flight(dev, c, A, act - wid, act + wid,
                                            ubs)
    most = _lp_define("WARP_LANES_MAX")
    assert solver.plan["path"] == "warp"
    assert solver.plan["lanes_per_cta"] == min(most, solver.K_pad)
    _hold_to_plain(solver, cf, Ad, pack, got)
    _lane_bar(solve_lp_batch(c, A, act - wid, act + wid, ubs,
                             backend="device", device=dev),
              solve_lp_batch(c, A, act - wid, act + wid, ubs, backend="np"))
    exact = _cold_flight(dev, K, 5, 60, 64, 8, K)
    assert exact[0].plan["lanes_per_cta"] == min(most, K)
    _hold_to_plain(*exact)


@pytest.mark.parametrize("m", [3, 7, 13, 20])
def test_lp_batch_warp_path_every_m_pad(dev, m):
    """m_pad 4, 8, 16 and 32 on the warp path, and the same flights on the
    CTA path (the WARP_N_MAX 0 build): both equal the plain version."""
    rng = np.random.default_rng(m)
    n = max(40, 2 * m)
    c, A = rng.normal(size=n), rng.normal(size=(m, n))
    ub = rng.integers(1, 4, size=n).astype(float)
    act = A @ (rng.uniform(0, 1, n) * ub)
    wid = np.abs(rng.normal(size=m)) * 2 + 0.5
    ubs = [ub * rng.uniform(0.5, 1.0, n) for _ in range(10)]
    solver, cf, Ad, pack, got = _one_flight(dev, c, A, act - wid, act + wid,
                                            ubs)
    assert solver.plan["path"] == "warp"
    _hold_to_plain(solver, cf, Ad, pack, got)
    _hold_to_plain(_on_cta(solver), cf, Ad, pack)


def test_lp_batch_warp_path_odd_n(dev):
    """N = 165 (an odd count of columns, so cf is no multiple of 16
    bytes, the bulk copy's unit): (cf, A) is not staged but read from
    global memory; lanes = plain."""
    flight = _cold_flight(dev, 8, 3, 150, 161, 4, 9)
    assert flight[0].plan["path"] == "warp" and not flight[0].plan["staged"]
    _hold_to_plain(*flight)


def test_lp_batch_staged_cf_a_must_be_aligned(dev):
    """A staged class given cf and A 8 bytes past a 16-byte boundary (the
    bulk copy's alignment) raises a ValueError instead of launching."""
    solver, cf, Ad, pack = _cold_flight(dev, 8, 3, 150, 160, 4, 9)
    assert solver.plan["path"] == "warp" and solver.plan["staged"]
    cf1 = torch.cat([cf.new_zeros(1), cf])[1:]
    A1 = torch.cat([Ad.new_zeros(1), Ad.reshape(-1)])[1:].view(Ad.shape)
    with pytest.raises(ValueError, match="16-byte"):
        solver(cf1, A1, pack)


def _integer_flight(seed, K=12):
    """A flight of integer data (costs in [-3, 3], A in {-1, 0, 1}, integer
    bounds) whose columns come in identical pairs: equal ratios (ties
    broken by index) and running sums that reach |delta| exactly; every
    fourth lane cannot reach row 0 (a select with no crossing)."""
    rng = np.random.default_rng(seed)
    h, m = 24, 3
    c = rng.integers(-3, 4, size=h).astype(float)
    A = rng.integers(-1, 2, size=(m, h)).astype(float)
    c, A = np.concatenate([c, c]), np.hstack([A, A])
    ub = rng.integers(1, 3, size=2 * h).astype(float)
    act = A @ np.floor(ub / 2)
    ubs = [np.minimum(ub, rng.integers(0, 3, size=2 * h)) for _ in range(K)]
    wid = rng.integers(0, 3, size=m).astype(float)
    for k in range(3, K, 4):
        ubs[k] = np.minimum(ubs[k], (A[0] < 0) * ubs[k])
    bl = act - wid
    bl[0] = max(bl[0], 1.0)
    return c, A, bl, act + wid, ubs


@pytest.mark.parametrize("seed", [2, 4])
def test_lp_batch_ties_and_exact_thresholds_on_both_paths(dev, seed):
    """The selects the ordered merge must get right, on the card: tied
    ratios, running sums equal to |delta|, and no crossing (infeasible
    lanes).  A lane's trajectory is its q and flip set each trip, so its
    basis, bound pattern, status and iterations, on the warp path and on
    the CTA path, equal the plain version's."""
    from repro_torch.core.lp import INFEASIBLE, OPTIMAL
    args = _integer_flight(seed)
    solver, cf, Ad, pack, got = _one_flight(dev, *args)
    assert solver.plan["path"] == "warp"
    _hold_to_plain(solver, cf, Ad, pack, got)
    status = set(got[:, solver.N + 2 * solver.m_pad + 1].tolist())
    assert {OPTIMAL, INFEASIBLE} <= status
    _hold_to_plain(_on_cta(solver), cf, Ad, pack)


def test_lp_batch_cf_a_not_staged(dev):
    """m_pad 32 and N = WARP_N_MAX: (cf, A) does not fit beside the lanes,
    so the warp path reads it from global memory; lanes = plain."""
    wn = _warp_n_max()
    flight = _cold_flight(dev, 5, 20, wn - 64, wn - 32, 32, 5)
    assert flight[0].plan["path"] == "warp" and not flight[0].plan["staged"]
    _hold_to_plain(*flight)


def test_lp_batch_warp_path_nan_costs(dev):
    """NaN costs on the warp path (NaN reduced costs, NaN ratios sorted
    after +inf by the ordered merge): statuses, iterations, basis and
    bound pattern equal the plain version's."""
    solver, cf, Ad, pack = _cold_flight(dev, 4, 4, 40, 48, 4, 6,
                                        nan_cost=True)
    assert solver.plan["path"] == "warp"
    got = solver(cf, Ad, pack)
    want = _plain_pack(solver, cf, Ad, pack)
    N, mp = solver.N, solver.m_pad
    o = N + mp
    for k in range(pack.shape[0]):
        g, w = got[k], want[k]
        assert np.array_equal(g[o + 1 + mp:o + 5 + mp],
                              w[o + 1 + mp:o + 5 + mp]), k
        assert np.array_equal(np.sort(g[o + 1:o + 1 + mp]),
                              np.sort(w[o + 1:o + 1 + mp])), k
        assert np.array_equal(g[o + 5 + mp:o + 5 + mp + N],
                              w[o + 5 + mp:o + 5 + mp + N]), k


def test_lp_batch_warp_path_budget_relaunch(dev):
    """The shared pivot cap truncating mid-flight on the warp path: two
    launches, and the out pack (spent included) equals the plain
    lockstep loop's."""
    from repro_torch.core.guard import SolveBudget
    from repro_torch.core.lp_batch import solve_lp_batch
    from repro_torch.kernels import lp_batch
    rng = np.random.default_rng(3)
    n, m = 60, 5
    c, A = rng.normal(size=n), rng.normal(size=(m, n))
    ub = rng.integers(1, 4, size=n).astype(float)
    act = A @ (rng.uniform(0, 1, n) * ub)
    wid = np.abs(rng.normal(size=m)) * 2 + 0.5
    ubs = [ub * rng.uniform(0.5, 1.0, n) for _ in range(8)]
    args = (c, A, act - wid, act + wid, ubs)
    its = [r.iters for r in solve_lp_batch(*args, backend="device",
                                           device="cpu")]
    cap = int(np.minimum(its, int(np.median(its))).sum())
    before = lp_batch.launches
    solver, cf, Ad, pack, got = _one_flight(
        dev, *args, budget=SolveBudget(max_pivots=cap))
    assert lp_batch.launches == before + 2
    assert solver.plan["path"] == "warp"
    _hold_to_plain(solver, cf, Ad, pack, got)


def test_lp_batch_both_paths_on_the_bnb_flights(dev):
    """Every flight of B&B at W = 64 on the reference benchmark's instance,
    on the warp path and on the CTA path: each lane equals the plain
    version on the card."""
    from repro_torch.core.ilp import solve_ilp
    from repro_torch.kernels import lp_batch
    c, A, bl, bu = _lp_instance(42, 150, 0.05)
    kept = []
    saved = lp_batch.LaneSolver.__call__

    def keep(self, cf, Ad, in_pack):
        kept.append((self, cf, Ad, in_pack.copy()))
        return saved(self, cf, Ad, in_pack)

    lp_batch.LaneSolver.__call__ = keep
    try:
        solve_ilp(c, A, bl, bu, np.ones(150), wave_width=64, device=dev,
                  max_nodes=50_000, time_limit_s=600)
    finally:
        lp_batch.LaneSolver.__call__ = saved
    assert len(kept) > 100
    cta = _cta_lib()
    for solver, cf, Ad, pack in kept:
        assert solver.plan["path"] == "warp"
        warp = _hold_to_plain(solver, cf, Ad, pack)
        other = _on_cta(solver, cta)
        bad, _, _ = lp_batch.lane_mismatches(other(cf, Ad, pack), warp,
                                             pack, solver.m_pad)
        assert not bad, bad


# ------------------------------------------------------ split-tree descent


def _tree_cases():
    """(name, partition, data) for every backend's tree, the bound-less
    merged tree and a single leaf (built on the CPU: the trees are host
    numpy)."""
    from repro_torch.core import partitioner
    rng = np.random.default_rng(7)
    X = np.concatenate([rng.normal(0, 1, (20_000, 3)),
                        rng.normal(7, 2, (20_000, 3))]) * [1.0, 4.0, 0.3]
    merged = np.full((3000, 2), 5.0)
    return [("dlv", partitioner.fit(X, backend="dlv", d_f=60,
                                    device="cpu"), X),
            ("kdtree", partitioner.fit(X, backend="kdtree", d_f=60,
                                       device="cpu"), X),
            ("bucketing", partitioner.fit(X, backend="bucketing", d_f=60,
                                          memory_rows=8000, device="cpu"),
             X),
            ("merged", partitioner.fit(merged, backend="bucketing",
                                       device="cpu"), merged),
            ("single", partitioner.fit(X[:50], backend="kdtree", tau=10**6,
                                       device="cpu"), X[:50])]


def test_split_tree_kernel_is_its_plain_version(dev):
    """Member rows, ties on the bounds, probes outside every box and NaN
    rows: the kernel's leaves equal the plain version's on the card, the
    packed mirror's, the replaced bisection kernel's and the host
    descent's, one launch a call (none for the bisection)."""
    from repro_torch.kernels import split_tree
    rng = np.random.default_rng(1)
    for name, part, data in _tree_cases():
        n, k = data.shape
        probes = [data, data[rng.choice(n, 5000)]]
        if len(part.tree.bounds):
            ties = data[rng.choice(n, 2000)].copy()
            for j in range(k):
                ties[:, j] = rng.choice(part.tree.bounds, len(ties))
            probes.append(ties)
        span = data.max(0) - data.min(0) + 1.0
        probes.append(data.max(0) + span * rng.uniform(1, 9, (1000, k)))
        probes.append(data.min(0) - span * rng.uniform(1, 9, (1000, k)))
        nan = data[rng.choice(n, 1000)].copy()
        nan[np.arange(1000), rng.integers(0, k, 1000)] = np.nan
        probes.append(nan)
        packed = part.tree.device_packed(dev)
        for T in probes:
            Td = torch.as_tensor(T, device=dev)
            before = split_tree.launches
            got = split_tree.descend_batch(Td, packed)
            torch.cuda.synchronize()
            assert split_tree.launches == before + 1, name
            want = split_tree.descend_batch_plain(Td, *packed.arrays,
                                                  packed.root)
            assert torch.equal(got, want), name
            assert torch.equal(
                split_tree.descend_batch_packed_plain(Td, packed), want), name
            before = split_tree.launches
            assert torch.equal(split_tree.descend_batch_bisect(Td, packed),
                               want), name
            assert split_tree.launches == before, name
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          part.tree.descend_batch(T),
                                          err_msg=name)
        np.testing.assert_array_equal(
            part.get_group_batch(data, jit=True, device=dev), part.gid,
            err_msg=name)


@pytest.mark.parametrize("budget", [0, 40, 1000, 20_000, None])
def test_split_tree_kernel_at_every_staging(dev, budget):
    """Whatever prefix of the packed layout a block stages (none, a few
    records, all records and some fences or lines, the wrapper's own
    plan), the leaves are the plain version's: rows as wide as the data, 4
    and 9 (the path that loads the value), ties on the bounds, and rows
    off a 16-byte boundary (no vector loads)."""
    from repro_torch.kernels import split_tree
    rng = np.random.default_rng(3)
    for name, part, data in _tree_cases():
        packed = part.tree.device_packed(dev)
        b = split_tree.STAGE_BYTES if budget is None else budget
        d = data.shape[1]
        for k in sorted({d, 4, 9}):
            T = rng.normal(size=(3001, k))
            T[:, :d] = data[rng.choice(len(data), 3001)]
            if len(part.tree.bounds):
                T[::2, :d] = rng.choice(part.tree.bounds, (1501, d))
            Td = torch.as_tensor(T, device=dev)
            off = torch.empty(T.size + 1, dtype=torch.float64,
                              device=dev)[1:].view(T.shape)
            off.copy_(Td)
            want = split_tree.descend_batch_plain(Td, *packed.arrays,
                                                  packed.root)
            p = split_tree.plan(packed, b)
            for rows in (Td, off):
                assert torch.equal(split_tree._launch(rows, packed, p),
                                   want), (name, k, p)


def test_split_tree_kernel_rejects_bad_inputs(dev):
    from repro_torch.kernels import split_tree
    _, part, data = _tree_cases()[1]
    packed = part.tree.device_packed(dev)
    T = torch.as_tensor(data[:100], device=dev)
    for bad in ((T.float(), packed), (T.t(), packed), (T[:, 0], packed),
                (T, part.tree.device_packed("cpu"))):
        with pytest.raises(ValueError):
            split_tree.descend_batch(*bad)
    got = split_tree.descend_batch(T[:0], packed)
    assert got.shape == (0,) and got.dtype == torch.int64
    big = split_tree.Plan(0, 0, split_tree.STAGE_MAX // 8 + 1, "over")
    with pytest.raises(ValueError, match="staged"):
        split_tree._launch(T, packed, big)


def test_append_descends_through_the_kernel_once(dev):
    """``Hierarchy.append`` on a card: one launch of the descent, the
    host descent's gids."""
    from repro_torch.core.hierarchy import Hierarchy
    from repro_torch.kernels import split_tree
    rng = np.random.default_rng(0)
    table = {"a": rng.normal(size=20_000), "b": rng.uniform(0, 5, 20_000)}
    h = Hierarchy(table, ["a", "b"], d_f=20, alpha=500, device=dev)
    rows = np.stack([rng.normal(size=300), rng.uniform(0, 5, 300)], 1)
    before = split_tree.launches
    rep = h.append(rows)
    assert split_tree.launches == before + 1
    np.testing.assert_array_equal(rep.gids,
                                  h.layers[1].part.tree.descend_batch(rows))
