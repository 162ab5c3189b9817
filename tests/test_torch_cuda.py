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
import time
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
    no other kernel, copy or fill on the card (``_kernels_of_one_call``)."""
    rng = np.random.default_rng(4)
    r, c, _ = _select_case("random", N, rng)
    ratio, cost = _t(r, dev), _t(c, dev)
    rr = pricing.ratio_range_plain(ratio)
    b = _t([0.3 * c.sum()], dev)
    select = bfrt.Selector(N, dev)
    select(ratio, cost, b, rng=rr)
    torch.cuda.synchronize()
    names = _kernels_of_one_call(lambda: select(ratio, cost, b, rng=rr))
    assert names and all(k.startswith("bfrt_") for k in names), names
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
    kernel, copy or fill on the card (``_kernels_of_one_call``)."""
    cs = _chip_smoke()
    vals, ids, G = cs.segstats_case(np.random.default_rng(12), "skewed 231",
                                    1_000_000, dev)
    segstats.segment_stats(vals, ids, G)
    torch.cuda.synchronize()
    names = _kernels_of_one_call(lambda: segstats.segment_stats(vals, ids,
                                                                G))
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


def _kernels_of_one_call(call) -> dict:
    """{kernel name: device records} of one ``call()`` under the profiler.

    The profiler can drop or mistime the first device records of a
    window, so the window opens as ``chip_smoke.per_call_device`` opens
    one: a torch op's kernel (an in-place add on one element), a sync,
    then 0.2 s; the opener's own record is left out.  A record still lost
    shows as a missing launch, and the caller's count fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    opener = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        opener.add_(1)
        torch.cuda.synchronize()
        time.sleep(0.2)
        call()
        torch.cuda.synchronize()
    names = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        key = ev.key.split("(")[0].replace("void ", "")
        if "elementwise_kernel" in key and "add" in key.lower():
            continue                                # the opener
        names[key] = names.get(key, 0) + ev.count
    return names


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


def _seed_held(dev, v, beta):
    """The certified seed kernel on ``v``: cuts bit-equal to the replaced
    serial kernel's, to ``seed_scan_certified_plain``'s and to
    ``dlv_scan_seed_plain``'s, and its counters (all but the cycles)
    equal to the mirror's.  Returns the counters."""
    vals = _t(v, dev)
    cuts, st = dlv_scan.dlv_scan_seed(vals, beta, stats=True)
    serial = dlv_scan.dlv_scan_seed(vals, beta, serial=True)
    want = {}
    mirror = dlv_scan.seed_scan_certified_plain(vals.cpu(), beta, stats=want)
    assert torch.equal(cuts.cpu(), mirror), beta
    assert torch.equal(serial.cpu(), mirror), beta
    assert torch.equal(mirror, dlv_scan.dlv_scan_seed_plain(vals.cpu(), beta))
    got = dict(zip(dlv_scan.SEED_STAT_NAMES, st.tolist()))
    for name in dlv_scan.SEED_STAT_NAMES:
        if not name.endswith("cycles"):
            assert got[name] == want[name], (name, got, want)
    return got


def test_dlv_scan_seed_certified_near_ties(dev):
    """A 100k-row span with beta at the running variance of ten rows (each
    beyond every earlier row of the first window) and one ulp to each
    side: every decision at those rows is a near-tie that the kernel's
    serial chain takes, and the cuts and counters are the mirror's."""
    from fractions import Fraction
    rng = np.random.default_rng(21)
    v = np.sort(rng.normal(0.0, 2.0, 100_000))
    v = v - v.mean()
    k = s1 = s2 = 0.0
    var, records, best = [], [], -np.inf
    for i, x in enumerate(v[:60_000]):
        k += 1.0
        s1 += x
        s2 += x * x
        m = s1 / k
        var.append(float(Fraction(s2 / k) - Fraction(m) * Fraction(m)))
        if i and var[-1] > best:
            records.append(i)
            best = var[-1]
    rows = [records[int(q)] for q in np.linspace(5, len(records) - 1, 10)]
    for r in rows:
        for beta in (var[r], np.nextafter(var[r], np.inf),
                     np.nextafter(var[r], -np.inf)):
            got = _seed_held(dev, v, float(beta))
            assert got["near_ties"] >= 1, (r, beta)


@pytest.mark.parametrize("kind", ["normal", "dups", "dups beta 0",
                                  "shift 1e4", "shift 1e8", "unsorted"])
def test_dlv_scan_seed_certified_spans(dev, kind):
    """Duplicate-heavy spans (flat variances; at beta 0 nearly every row a
    near-tie), spans far from zero (m^2 >> var) and an unsorted span:
    the kernel against the serial kernel and the mirror."""
    rng = np.random.default_rng(len(kind))
    n = 20_000
    if kind == "normal":
        v = np.sort(rng.normal(0.0, 2.0, 200_000))
    elif kind.startswith("dups"):
        v = np.sort(np.round(rng.normal(0.0, 3.0, n), 1))
    elif kind.startswith("shift"):
        v = np.sort(rng.normal(float(kind.split()[1]), 1.0, n))
    else:
        v = rng.normal(0.0, 1.0, n)
    if not kind.startswith("shift"):
        v = v - v.mean()
    beta = 0.0 if kind == "dups beta 0" else 13.5 * v.var() / 100 ** 2
    got = _seed_held(dev, v, beta)
    if kind == "normal":
        assert got["serial_rows"] < 0.01 * len(v) and got["near_ties"] == 0


@pytest.mark.parametrize("case", ["nan", "inf", "-inf", "beta nan",
                                  "beta inf", "beta -inf", "beta 0",
                                  "beta -1"])
def test_dlv_scan_seed_certified_non_finite(dev, case):
    v = np.sort(np.random.default_rng(3).normal(0.0, 1.0, 3000))
    beta = 1e-3
    if case.startswith("beta"):
        beta = float(case.split()[1])
    else:
        v[1200] = float(case)
    _seed_held(dev, v, beta)


def test_dlv_scan_seed_certified_past_one_chunk_of_tiles(dev):
    """17M rows: more than one chunk of tile totals (4,096 tiles of 4,096
    rows), so the totals' scan carries between chunks, and windows of
    ~600k rows, where the band (it grows with k m^2 / var) leaves a
    near-tie that the reference's chain walks for the whole window.  Cuts
    equal to the replaced serial kernel's, counters to the mirror's."""
    rng = np.random.default_rng(17)
    v = np.sort(rng.normal(0.0, 2.0, 17_000_000))
    v = v - v.mean()
    beta = 13.5 * float(v.var()) / 100 ** 2
    vals = _t(v, dev)
    cuts, st = dlv_scan.dlv_scan_seed(vals, beta, stats=True)
    assert torch.equal(cuts, dlv_scan.dlv_scan_seed(vals, beta, serial=True))
    want = {}
    mirror = dlv_scan.seed_scan_certified_plain(vals.cpu(), beta, stats=want)
    assert torch.equal(cuts.cpu(), mirror)
    got = dict(zip(dlv_scan.SEED_STAT_NAMES, st.tolist()))
    for name in dlv_scan.SEED_STAT_NAMES:
        if not name.endswith("cycles"):
            assert got[name] == want[name], (name, got, want)
    assert got["near_ties"] >= 1 and got["serial_rows"] > 100_000


def test_dlv_scan_seed_certified_offset_view(dev):
    """A span that is a view 8 bytes off a 16-byte boundary: the kernels
    read x 8 bytes at a time, so any address serves."""
    rng = np.random.default_rng(4)
    v = np.sort(rng.normal(0.0, 2.0, 30_001))
    base = _t(v - v.mean(), dev)
    view = base[1:]
    assert view.data_ptr() % 16 == 8
    beta = 13.5 * float(view.var()) / 100 ** 2
    assert torch.equal(dlv_scan.dlv_scan_seed(view, beta).cpu(),
                       dlv_scan.dlv_scan_seed_plain(view.cpu(), beta))


def test_dlv_scan_seed_counts_one_launch_a_call(dev):
    """``seed_launches`` counts calls (four kernels each), the replaced
    kernel's calls go to ``seed_serial_launches``, and an empty span
    launches nothing."""
    v = _t(np.linspace(-1.0, 1.0, 50_000), dev)
    kernels.reset_launches()
    dlv_scan.seed_serial_launches = 0
    dlv_scan.dlv_scan_seed(v, 1e-4)
    dlv_scan.dlv_scan_seed(v, 1e-4, stats=True)
    assert kernels.launch_counts()["dlv_scan_seed"] == 2
    dlv_scan.dlv_scan_seed(v, 1e-4, serial=True)
    dlv_scan.dlv_scan_seed(v[:0], 1e-4)
    assert kernels.launch_counts()["dlv_scan_seed"] == 2
    assert dlv_scan.seed_serial_launches == 1


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
    """Prefix-LM with an int prefix and cross-attention launch the kernel;
    what it does not take raises (a per-batch prefix tensor, a window on a
    full call, causal with Sq != Sk, a (q/k, v) head_dim pair it lacks);
    a caller's scale reaches the kernel (MLA's), nothing falls back."""
    from repro_torch.models.attention import chunked_attention
    q = torch.zeros(1, 64, 4, 64, device=dev)
    k = v = torch.zeros(1, 64, 2, 64, device=dev)
    pos = torch.arange(64, device=dev)
    before = attention.launches
    chunked_attention(q, k, v, pos, pos, causal=True, prefix_len=8)
    chunked_attention(q, k[:, :40], v[:, :40], pos, pos[:40].clone(),
                      causal=False)
    assert attention.launches == before + 2
    with pytest.raises(NotImplementedError, match="prefix_len"):
        chunked_attention(q, k, v, pos, pos, causal=True,
                          prefix_len=torch.tensor([8], device=dev))
    with pytest.raises(NotImplementedError, match="window"):
        chunked_attention(q, k, v, pos, pos, causal=False, window=16)
    with pytest.raises(NotImplementedError, match="causal"):
        chunked_attention(q, k[:, :40], v[:, :40], pos, pos[:40],
                          causal=True)
    with pytest.raises(ValueError, match="Sq == Sk"):
        attention.flash_attention(q, k[:, :40].contiguous(),
                                  v[:, :40].contiguous(), causal=True)
    with pytest.raises(ValueError):
        attention.flash_attention(q[..., :32].contiguous(),
                                  k[..., :32].contiguous(),
                                  v[..., :32].contiguous())
    with pytest.raises(ValueError, match="head_dim"):
        chunked_attention(torch.zeros(1, 64, 4, 192, device=dev),
                          torch.zeros(1, 64, 2, 192, device=dev),
                          torch.zeros(1, 64, 2, 192, device=dev), pos, pos,
                          causal=True)
    before = attention.launches
    chunked_attention(q, k, v, pos, pos, causal=True, scale=0.5)
    assert attention.launches == before + 1


@pytest.mark.parametrize("S", [128, 1000, 4096])
@pytest.mark.parametrize("H", [4, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_mla(dev, S, H, dtype):
    """MLA's instantiation: q/k head_dim 192 (nope 128 + rope 64), v
    head_dim 128, H = KV heads, causal, the caller's scale 1/sqrt(192),
    against the plain version with that scale, at a few heads and at
    deepseek's 128, S across tiles and ragged (1,000), held to the card
    check's bar."""
    rng = np.random.default_rng(S + H)
    q, k = (_t(rng.normal(size=(1, S, H, 192)), dev, torch.float32).to(dtype)
            for _ in range(2))
    v = _t(rng.normal(size=(1, S, H, 128)), dev, torch.float32).to(dtype)
    scale = 1.0 / np.sqrt(192.0)
    before = attention.launches
    got = attention.flash_attention(q, k, v, causal=True, scale=scale)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    assert got.shape == (1, S, H, 128) and got.dtype == dtype
    want = attention.flash_attention_plain(q, k, v, causal=True, scale=scale)
    assert bool(torch.isfinite(got).all())
    err, over, rel, ok = _flash_agreement()(got, want)
    assert ok, (f"max abs err {err}, {over} of the elementwise limit, "
                f"relative norm {rel}")


def _mla_cfg(**changes):
    """deepseek-smoke in float32 at capacity 8.0 (no copy drops), with
    the changes."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("deepseek-v3-671b").smoke(),
                               param_dtype="float32", capacity_factor=8.0,
                               **changes)


def test_mla_prefill_goes_through_the_kernel(dev):
    """deepseek-smoke widened to MLA's head dims (nope 128, rope 64, v
    128): prefill on the card launches the (192, 128) kernel once per
    layer (dense and MoE) and agrees with 12 absorbed decode steps
    (2e-3, the reference's bar)."""
    from repro_torch.models import Model
    cfg = _mla_cfg(qk_nope_head_dim=128, qk_rope_head_dim=64,
                   v_head_dim=128)
    model = Model(cfg, device=dev).init(seed=0)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (1, 12)), device=dev)
    before = attention.launches
    full = model.prefill_logits({"tokens": toks})
    assert attention.launches == before + cfg.num_layers
    cache = model.init_cache(1, 16)
    for t in range(12):
        logits, cache = model.decode_step(cache, toks[:, t:t + 1])
        torch.testing.assert_close(logits, full[:, t], rtol=2e-3, atol=2e-3)


def test_mla_greedy_tokens_on_the_card_equal_the_cpus(dev):
    """deepseek-smoke in float32 at its default capacity, the same seeded
    parameters on the card and on the CPU: ``generate_batch`` gives the
    same greedy tokens (decode steps only, absorbed MLA over the latent
    cache)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import ServingEngine
    cfg = dataclasses.replace(get_config("deepseek-v3-671b").smoke(),
                              param_dtype="float32")
    cpu = Model(cfg, device="cpu").init(seed=0)
    card = Model(cfg, device=dev).load_params(cpu.params)
    prompts = np.random.default_rng(5).integers(
        1, cfg.vocab_size, (4, 10)).astype(np.int32)
    want = ServingEngine(cpu, cache_len=32).generate_batch(prompts, 8)
    got = ServingEngine(card, cache_len=32).generate_batch(prompts, 8)
    np.testing.assert_array_equal(got, want)


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


# ------------------------------------------------ mixture of experts


def test_moe_greedy_tokens_on_the_card_equal_the_cpus(dev):
    """mixtral-smoke in float32, the same seeded parameters on the card and
    on the CPU: ``generate_batch`` gives the same greedy tokens (decode
    steps only: the smoke head_dim of 32 is no flash shape).  Four prompts
    a step at the default capacity, so copies may drop, alike on both."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import ServingEngine
    cfg = dataclasses.replace(get_config("mixtral-8x22b").smoke(),
                              param_dtype="float32")
    cpu = Model(cfg, device="cpu").init(seed=0)
    card = Model(cfg, device=dev).load_params(cpu.params)
    prompts = np.random.default_rng(5).integers(
        1, cfg.vocab_size, (4, 10)).astype(np.int32)
    want = ServingEngine(cpu, cache_len=32).generate_batch(prompts, 8)
    got = ServingEngine(card, cache_len=32).generate_batch(prompts, 8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("K", [2, 4])
def test_moe_layer_on_the_card(dev, K):
    """A MoE layer of 8 experts (d_model 512, expert width 1,024) on 1,024
    tokens, top-K: in bf16 at the default capacity two runs give the same
    bits (the combine adds a token's slots in k order, no atomics); in
    float32 at capacity 8.0 it is the dense oracle's within 2e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.param import init_params
    cfg = dataclasses.replace(get_config("mixtral-8x22b").smoke(),
                              num_experts=8, num_experts_per_tok=K,
                              d_model=512, moe_d_ff=1024)
    g = torch.Generator(device=dev).manual_seed(K)
    p = init_params(moe.moe_spec(cfg), g, torch.bfloat16, dev)
    x = torch.randn((4, 256, cfg.d_model), generator=g, device=dev)
    a, aux_a = moe.apply_moe(p, cfg, x.bfloat16())
    b, aux_b = moe.apply_moe(p, cfg, x.bfloat16())
    assert bool(torch.isfinite(a.float()).all())
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    cfg8 = dataclasses.replace(cfg, capacity_factor=8.0)
    p32 = {k: v.float() for k, v in p.items()}
    out, _ = moe.apply_moe(p32, cfg8, x)
    torch.testing.assert_close(out, moe.ref_moe(p32, cfg8, x), rtol=2e-4,
                               atol=2e-4)


# ------------------------------------------------- SSM and hybrid stacks


@pytest.mark.parametrize("S", [64, 96])
def test_ssm_layer_on_the_card_equals_the_cpu(dev, S):
    """mamba2-smoke's SSD layer in float32, the same seeded parameters and
    inputs on the card and on the CPU: ``ssd_forward`` over 2 and 3
    chunks, then 16 ``ssm_decode`` steps (outputs and both caches), 1e-5."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models.param import init_params
    cfg = dataclasses.replace(get_config("mamba2-1.3b").smoke(),
                              param_dtype="float32")
    cpu = init_params(ssm.ssm_spec(cfg), torch.Generator().manual_seed(0),
                      torch.float32, "cpu")
    card = {k: v.to(dev) for k, v in cpu.items()}
    x = torch.randn((2, S, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    torch.testing.assert_close(ssm.ssd_forward(card, cfg, x.to(dev)).cpu(),
                               ssm.ssd_forward(cpu, cfg, x), rtol=1e-5,
                               atol=1e-5)
    c_cpu = ssm.ssm_init_cache(cfg, 2, torch.float32, "cpu")
    c_card = ssm.ssm_init_cache(cfg, 2, torch.float32, dev)
    for t in range(16):
        want, c_cpu = ssm.ssm_decode(cpu, cfg, x[:, t:t + 1], c_cpu)
        got, c_card = ssm.ssm_decode(card, cfg, x[:, t:t + 1].to(dev),
                                     c_card)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    for k in ("state", "conv"):
        torch.testing.assert_close(c_card[k].cpu(), c_cpu[k], rtol=1e-5,
                                   atol=1e-5)


def test_ssm_hybrid_prefill_goes_through_the_kernel(dev):
    """jamba-smoke cut to one period of 4 and widened to head_dim 128 (the
    smoke head_dim of 32 is no flash shape), float32 at capacity 8.0:
    prefill on the card launches the (128, 128) kernel once per period,
    agrees with the CPU's prefill and with 64 decode steps on the card
    (2e-3, the reference's bar)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b").smoke(),
                              num_layers=4, attn_period=4, head_dim=128,
                              param_dtype="float32", capacity_factor=8.0)
    cpu = Model(cfg, device="cpu").init(seed=0)
    model = Model(cfg, device=dev).load_params(cpu.params)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (1, 64)))
    before = attention.launches
    full = model.prefill_logits({"tokens": toks.to(dev)})
    assert attention.launches == before + 1
    torch.testing.assert_close(full.cpu(), cpu.prefill_logits(
        {"tokens": toks}), rtol=2e-3, atol=2e-3)
    cache = model.init_cache(1, 64)
    for t in range(64):
        logits, cache = model.decode_step(cache, toks[:, t:t + 1].to(dev))
        torch.testing.assert_close(logits, full[:, t], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_ssm_greedy_tokens_on_the_card_equal_the_cpus(dev, arch):
    """mamba2-smoke and jamba-smoke in float32, the same seeded parameters
    on the card and on the CPU: ``generate_batch`` gives the same greedy
    tokens (decode steps only)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import ServingEngine
    cfg = dataclasses.replace(get_config(arch).smoke(), param_dtype="float32")
    cpu = Model(cfg, device="cpu").init(seed=0)
    card = Model(cfg, device=dev).load_params(cpu.params)
    prompts = np.random.default_rng(5).integers(
        1, cfg.vocab_size, (4, 10)).astype(np.int32)
    want = ServingEngine(cpu, cache_len=32).generate_batch(prompts, 8)
    got = ServingEngine(card, cache_len=32).generate_batch(prompts, 8)
    np.testing.assert_array_equal(got, want)


# ----------------------------------- encoder-decoder and VLM (flash modes)


def _flash_held(q, k, v, **kw):
    """One launch of the kernel on (q, k, v) held to the card check's bar
    against the plain version."""
    before = attention.launches
    got = attention.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    want = attention.flash_attention_plain(q, k, v, **kw)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    err, over, rel, ok = _flash_agreement()(got, want)
    assert ok, (f"max abs err {err}, {over} of the elementwise limit, "
                f"relative norm {rel}")


def _qkv(dev, rng, B, Sq, Sk, H, KV, d, dv, dtype):
    return tuple(_t(rng.normal(size=(B, S, h, w)), dev, torch.float32)
                 .to(dtype) for S, h, w in ((Sq, H, d), (Sk, KV, d),
                                            (Sk, KV, dv)))


@pytest.mark.parametrize("Sq,Sk", [(48, 1500), (130, 65), (200, 2048),
                                   (1, 77)])
@pytest.mark.parametrize("H,KV", [(8, 8), (8, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_encdec_cross_kernel(dev, Sq, Sk, H, KV, dtype):
    """Cross-attention, Whisper's head_dim 64: Sq queries over Sk keys,
    ragged both ways (Sq and Sk off the 128-row, 64-row and 64-key tiles),
    MHA and MQA (KV = 1), full mask."""
    rng = np.random.default_rng(Sq * 7 + Sk + KV)
    _flash_held(*_qkv(dev, rng, 2, Sq, Sk, H, KV, 64, 64, dtype),
                causal=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_encdec_full_over_padded_keys(dev, dtype):
    """Whisper's encoder call: 1,500 queries over 2,048 keys whose last
    548 are the reference's zero padding, held to the plain version; then
    ``chunked_attention`` on the card (which pads a full call to the
    reference's chunk itself) against the CPU's reference scan at Sk =
    1,500, in float32 to 2e-3 (the reference's kernel bar)."""
    from repro_torch.models.attention import chunked_attention
    rng = np.random.default_rng(15)
    q, k, v = _qkv(dev, rng, 2, 1500, 1500, 8, 8, 64, 64, dtype)
    pad = [torch.cat([t, torch.zeros_like(t[:, :548])], dim=1)
           for t in (k, v)]
    _flash_held(q, *pad, causal=False)
    if dtype == torch.float32:
        pos = torch.arange(1500)
        before = attention.launches
        got = chunked_attention(q, k, v, pos.to(dev), pos.to(dev),
                                causal=False)
        assert attention.launches == before + 1
        want = chunked_attention(q.cpu(), k.cpu(), v.cpu(), pos, pos,
                                 causal=False)
        torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("prefix", [0, 1, 100, 256, 300, 5000])
@pytest.mark.parametrize("S", [320, 777])
@pytest.mark.parametrize("d,H,KV", [(64, 8, 2), (256, 8, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_prefix_kernel(dev, prefix, S, d, H, KV, dtype):
    """Prefix-LM: causal, keys below ``prefix`` attended by every query
    (0: plain causal; 1; inside the first tiles; PaliGemma's 256; past a
    128-row tile's edge; beyond S), at head_dim 64 and PaliGemma's (256,
    256) with one KV head."""
    rng = np.random.default_rng(prefix + S + d)
    _flash_held(*_qkv(dev, rng, 2, S, S, H, KV, d, d, dtype), causal=True,
                prefix=prefix)


@pytest.mark.parametrize("S", [1, 64, 65, 200, 1024])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100),
                                           (False, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_hd256_kernel(dev, S, causal, window, dtype):
    """The (256, 256) pair: causal, windowed and full, S across the
    64-row query tiles and the 64-key tiles, 8 query heads on 1 KV head
    (PaliGemma's)."""
    rng = np.random.default_rng(S + window)
    _flash_held(*_qkv(dev, rng, 2, S, S, 8, 1, 256, 256, dtype),
                causal=causal, window=window)


# the digests of the kernel before prefix-LM, cross-attention and (256,
# 256) were added (``scripts/flash_digests.py`` on that tree, H100 80GB
# HBM3)
FLASH_DIGESTS_BEFORE = {
    "64x64 causal bfloat16": "212446d850cafbc2",
    "64x64 causal float32": "7c40c8586ee8142e",
    "64x64 window bfloat16": "324d27bd3bf08a19",
    "64x64 window float32": "cb427fb517aae064",
    "64x64 full bfloat16": "a1a104898ed6e01f",
    "64x64 full float32": "b56a4e9cde1dca91",
    "120x120 causal bfloat16": "2100086f9376b49d",
    "120x120 causal float32": "d1cf633ac44df571",
    "120x120 window bfloat16": "2690398608dd1f9f",
    "120x120 window float32": "940e4ef7607c5c83",
    "120x120 full bfloat16": "e4a6f776ff276b77",
    "120x120 full float32": "c2d1680cbd23cd71",
    "128x128 causal bfloat16": "4c8e67ac7d081de0",
    "128x128 causal float32": "34df42158f8428dc",
    "128x128 window bfloat16": "8dafa579ebc0c8ad",
    "128x128 window float32": "4254bc98d4f01324",
    "128x128 full bfloat16": "028ecba1cdc436f1",
    "128x128 full float32": "0763e9dd808e3a32",
    "192x128 causal bfloat16": "9522a2188a0bfaee",
    "192x128 causal float32": "49b7008e48b226db",
    "192x128 window bfloat16": "949e81c7a8419a4a",
    "192x128 window float32": "952a21aec62e7358",
    "192x128 full bfloat16": "9b745d7c3ab986c5",
    "192x128 full float32": "c1a46b58a5987e8a",
}


def test_flash_existing_pairs_bits_unchanged_by_prefix_and_cross(dev):
    """Every pair the kernel had before prefix-LM, cross-attention and
    (256, 256), in both dtypes, causal, windowed and full at S = 200:
    the same bits as the kernel before the change (digests of its
    outputs)."""
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "flash_digests.py"
    spec = importlib.util.spec_from_file_location("flash_digests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = mod.digests(attention)
    assert set(got) == set(FLASH_DIGESTS_BEFORE)
    assert got == FLASH_DIGESTS_BEFORE


def _encdec_cfg(arch, **changes):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).smoke(),
                               param_dtype="float32", **changes)


@pytest.mark.parametrize("enc_len", [64, 1500])
def test_encdec_prefill_goes_through_the_kernel(dev, enc_len):
    """whisper-smoke widened to head_dim 64, float32: prefill on the card
    launches the kernel once per encoder layer and twice per decoder
    layer (self, cross) and agrees with the CPU's prefill (2e-3); at 64
    frames (no padded chunk) with 12 decode steps after
    ``prefill_with_cache`` too (2e-3)."""
    from repro_torch.models import Model
    cfg = _encdec_cfg("whisper-base", head_dim=64, encoder_seq_len=enc_len)
    cpu = Model(cfg, device="cpu").init(seed=0)
    model = Model(cfg, device=dev).load_params(cpu.params)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (2, 12))
    frames = rng.normal(size=(2, enc_len, cfg.d_model)).astype(np.float32)
    batch = {"tokens": toks, "enc_inputs": frames}
    before = attention.launches
    full = model.prefill_logits(batch)
    assert attention.launches == before + cfg.num_encoder_layers \
        + 2 * cfg.num_layers
    torch.testing.assert_close(full.cpu(), cpu.prefill_logits(batch),
                               rtol=2e-3, atol=2e-3)
    if enc_len > 1024:
        return
    _, cache = model.prefill_with_cache(
        {"tokens": toks[:, :1], "enc_inputs": frames}, 16)
    for t in range(1, 12):
        logits, cache = model.decode_step(cache, toks[:, t:t + 1])
        torch.testing.assert_close(logits, full[:, t], rtol=2e-3, atol=2e-3)


def test_vlm_prefix_prefill_goes_through_the_kernel(dev):
    """paligemma-smoke widened to head_dim 256 (one KV head, 16 patches),
    float32: prefill on the card launches the (256, 256) kernel with the
    prefix once per layer and agrees with the CPU's (2e-3)."""
    from repro_torch.models import Model
    cfg = _encdec_cfg("paligemma-3b", head_dim=256)
    cpu = Model(cfg, device="cpu").init(seed=0)
    model = Model(cfg, device=dev).load_params(cpu.params)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, (2, 40)),
             "prefix": rng.normal(size=(2, cfg.num_prefix_tokens,
                                        cfg.d_model)).astype(np.float32)}
    before = attention.launches
    full = model.prefill_logits(batch)
    assert attention.launches == before + cfg.num_layers
    torch.testing.assert_close(full.cpu(), cpu.prefill_logits(batch),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ["whisper-base", "paligemma-3b"])
def test_encdec_greedy_tokens_on_the_card_equal_the_cpus(dev, arch):
    """whisper-smoke and paligemma-smoke in float32, the same seeded
    parameters on the card and on the CPU: ``generate_batch`` gives the
    same greedy tokens (decode steps only; the cross cache the zeros of
    ``init_cache``, no prefix, as in the reference's engine)."""
    from repro_torch.models import Model
    from repro_torch.serving import ServingEngine
    cfg = _encdec_cfg(arch)
    cpu = Model(cfg, device="cpu").init(seed=0)
    card = Model(cfg, device=dev).load_params(cpu.params)
    prompts = np.random.default_rng(5).integers(
        1, cfg.vocab_size, (4, 10)).astype(np.int32)
    want = ServingEngine(cpu, cache_len=32).generate_batch(prompts, 8)
    got = ServingEngine(card, cache_len=32).generate_batch(prompts, 8)
    np.testing.assert_array_equal(got, want)


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


# ------------------------------------------- distributed pricing (world 1)


@pytest.fixture(scope="module")
def dist_meshes(tmp_path_factory):
    """A process group of one rank with both backends (gloo for CPU
    tensors, NCCL for CUDA tensors) and a (1, 1) mesh on each device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.cuda.set_device(0)
    store = dist.FileStore(str(tmp_path_factory.mktemp("dist") / "store"), 1)
    dist.init_process_group("cpu:gloo,cuda:nccl", store=store, rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        yield {d: init_device_mesh(d, (1, 1), mesh_dim_names=("data",
                                                              "model"))
               for d in ("cuda", "cpu")}
    finally:
        dist.destroy_process_group()


def _dist_package_lp(seed, n, m=6):
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


@pytest.mark.parametrize("seed, budget", [(0, 25.0), (1, 3.0), (2, 400.0)])
def test_dist_pricing_step_on_the_card_is_the_cpu_step(dist_meshes, seed,
                                                       budget):
    """The NCCL world-1 pricing step at N = 100,004 (one launch each of
    pricing and the histogram) against the same step on the gloo world:
    the selection and the flip mask exact, the sums 1e-12 relative."""
    from repro_torch.core.distributed import make_pq_step
    rng = np.random.default_rng(seed)
    m, N = 4, 100_004
    A, lo, hi = rng.normal(size=(m, N)), np.zeros(N), rng.uniform(1, 3, N)
    state = rng.integers(0, 3, N)
    rho = rng.normal(size=m)
    d = rng.normal(size=N) - rng.normal(size=m) @ A
    outs = {}
    for kind, mesh in dist_meshes.items():
        step = make_pq_step(mesh, m, N)[0]
        dv = torch.device(kind)
        p0, b0 = pricing.launches, bfrt.launches
        outs[kind] = [o.cpu() for o in step(
            _t(A, dv), _t(d, dv), _t(lo, dv), _t(hi, dv),
            _t(state, dv, torch.int32), _t(rho, dv), 1.0, budget)]
        if kind == "cuda":
            torch.cuda.synchronize()
            assert (pricing.launches - p0, bfrt.launches - b0) == (1, 1)
    names = ("alpha", "flip_mask", "r_best", "q", "d_q", "at_up_q", "Acol",
             "fvec", "n_flips", "has_cross", "exact")
    for name, g, w in zip(names, outs["cuda"], outs["cpu"]):
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12,
                                       msg=name)
        else:
            assert torch.equal(g, w), name


@pytest.mark.parametrize("seed, n", [(0, 800), (3, 800), (2, 100_000)])
def test_dist_solve_on_the_card_is_the_cpu_solve(dist_meshes, seed, n):
    """``solve_lp_dist`` on the card against the gloo world's: the same
    pivots, pivot_stats and basis, the objective 1e-9 relative."""
    from repro_torch.core.distributed import solve_lp_dist
    lp = _dist_package_lp(seed, n)
    got = solve_lp_dist(*lp, mesh=dist_meshes["cuda"], device="cuda")
    want = solve_lp_dist(*lp, mesh=dist_meshes["cpu"], device="cpu")
    assert got.status == want.status == 0
    assert (got.iters, got.pivot_stats) == (want.iters, want.pivot_stats)
    assert np.array_equal(np.sort(got.basis), np.sort(want.basis))
    assert got.obj == pytest.approx(want.obj, rel=1e-9, abs=1e-9)


# ------------------------------------------ the flash backward and training


def _bwd_case(dev, case, mask, dtype):
    return _chip_smoke().bwd_inputs(case, mask, dtype, dev)


BWD_PAIR_IDS = ["64x64", "120x120", "128x128", "192x128", "256x256"]


def _bwd_pair(cs, pair):
    return next(c for c in cs.BWD_PAIRS if f"{c[0]}x{c[1]}" == pair)


@pytest.mark.parametrize("mask", ["causal", "window", "prefix", "cross",
                                  "one row", "S=129", "S=129 prefix",
                                  "S=257 window"])
@pytest.mark.parametrize("pair", BWD_PAIR_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernels_are_their_plain_version(dev, pair, mask, dtype):
    """The three backward kernels against ``flash_attention_bwd_plain`` on
    the kernel's own O and LSE, for every pair, dtype and mask of the
    forward (S = 200; cross: 150 queries over 333 keys) and the shapes
    ragged over the tensor-core kernels' tiles (``BWD_RAGGED``: one query
    row over 129 keys, S = 129 and 257): dQ, dK, dV within
    ``chip_smoke.BWD_TOL`` in relative norm (float32 1e-5; bf16 2^-8, P
    and dS one bf16 rounding each on the tensor cores, each output
    rounded once); the forward's output bit-identical with and without
    ``lse``; the LSE within 1e-5 of max(1, |plain|).  One
    ``bwd_launches`` a call, and one ``bwd_tc_launches`` where the pair
    and dtype take the tensor cores (bf16 below (256, 256))."""
    cs = _chip_smoke()
    case = _bwd_pair(cs, pair)
    m = next(x for x in cs.BWD_MASKS + cs.BWD_RAGGED if x[0] == mask)
    *qkv, do = _bwd_case(dev, case, m, dtype)
    before, tc = attention.bwd_launches, attention.bwd_tc_launches
    cs.bwd_hold(*qkv, do, **m[3])
    assert attention.bwd_launches == before + 1
    on_tc = dtype == "bfloat16" and pair != "256x256"
    assert attention.bwd_tc_launches == tc + on_tc


@pytest.mark.parametrize("mask", ["causal", "cross", "S=257 window"])
@pytest.mark.parametrize("pair", BWD_PAIR_IDS)
def test_flash_bwd_bf16_rerun_is_bit_identical(dev, pair, mask):
    """``chip_smoke.bwd_rerun``: the bf16 backward twice on the same
    inputs gives the same bits (no atomics: every gradient element is one
    block's sum in a fixed order)."""
    cs = _chip_smoke()
    m = next(x for x in cs.BWD_MASKS + cs.BWD_RAGGED if x[0] == mask)
    *qkv, do = _bwd_case(dev, _bwd_pair(cs, pair), m, "bfloat16")
    cs.bwd_rerun(*qkv, do, **m[3])


@pytest.mark.parametrize("pair, dtype, want", [
    ("128x128", "bfloat16", ("flash_bwd_dkdv_tc", "flash_bwd_dq_tc")),
    ("256x256", "bfloat16", ("flash_bwd_dkdv", "flash_bwd_dq")),
    ("128x128", "float32", ("flash_bwd_dkdv", "flash_bwd_dq"))])
def test_flash_bwd_route_by_kernel_name(dev, pair, dtype, want):
    """The profiler's kernels of backward calls, as phase 43 reads them
    (``chip_smoke.bwd_device``, through ``per_call_device``): bf16 (128,
    128) launches the tensor-core kernels and none of the CUDA-core ones;
    bf16 (256, 256) and float32 the CUDA-core ones.  The profiler can drop
    a window's first device records, so the names are held, not the
    counts."""
    cs = _chip_smoke()
    m = cs.BWD_MASKS[0]
    *qkv, do = _bwd_case(dev, _bwd_pair(cs, pair), m, dtype)
    o, lse = attention.flash_attention_fwd(*qkv, want_lse=True, **m[3])
    names = set(cs.bwd_device(
        lambda: attention.flash_attention_bwd(*qkv, o, lse, do, **m[3]),
        4)[1])
    other = set(cs.BWD_TC + cs.BWD_CUDA_CORES) - set(want)
    assert set(want) <= names and not names & other, names


def test_flash_forward_bits_unchanged_by_lse(dev):
    """The forward's output with ``lse`` written, on every case of
    ``scripts/flash_digests.py``: the digests recorded from the kernel
    before the backward existed, and the same bits as the launch without
    ``lse`` on the extra cases ((256, 256), prefix-LM, cross)."""
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "flash_digests.py"
    spec = importlib.util.spec_from_file_location("flash_digests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.digests(attention, lse=True) == FLASH_DIGESTS_BEFORE
    assert mod.digests(attention, cases=mod.EXTRA_CASES, lse=True) == \
        mod.digests(attention, cases=mod.EXTRA_CASES)


def test_flash_autograd_function_against_finite_differences(dev):
    """``FlashAttentionFn`` (the forward kernel with ``lse``, the backward
    kernels) on a tiny causal float32 case: the directional derivative of
    sum(o * w) along 8 random directions against central differences of
    the forward kernel at eps = 1e-2, within 1e-2 relative (truncation
    ~eps^2, float32 rounding ~1e-7 |L| / eps).  The kernel takes no
    float64, so ``gradcheck`` does not apply."""
    rng = np.random.default_rng(11)
    q, k, v, w = (_t(rng.normal(size=s), dev, torch.float32)
                  for s in ((1, 20, 2, 64), (1, 20, 1, 64), (1, 20, 1, 64),
                            (1, 20, 2, 64)))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = attention.bwd_launches
    out = attention.flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad((out * w).sum(), leaves)
    assert attention.bwd_launches == before + 1

    def loss(a, b, c):
        with torch.no_grad():
            return float((attention.flash_attention(a, b, c, causal=True)
                          * w).double().sum())
    eps = 1e-2
    for _ in range(8):
        u = [_t(rng.normal(size=x.shape), dev, torch.float32)
             for x in (q, k, v)]
        fd = (loss(*(x + eps * d for x, d in zip((q, k, v), u)))
              - loss(*(x - eps * d for x, d in zip((q, k, v), u)))) / (2 * eps)
        an = sum(float((g * d).sum()) for g, d in zip(grads, u))
        assert abs(fd - an) <= 1e-2 * max(abs(an), 1.0), (fd, an)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "h2o-danube-3-4b",
                                  "deepseek-v3-671b", "mamba2-1.3b",
                                  "whisper-base", "paligemma-3b"])
def test_widened_smoke_train_step_on_the_card_equals_the_cpus(dev, arch):
    """``chip_smoke.train_smoke_step``: one float32 step of the widened
    smoke config on the card and on the CPU from the same parameters and
    batch (``TRAIN_SMOKE_TOL``: metrics 1e-5, moments 1e-4 of each leaf's
    largest or 2^-8 where they are bf16, the whole update 1e-3 in relative
    norm; one forward and one backward flash launch per attention
    call)."""
    _chip_smoke().train_smoke_step(arch, dev)


def test_train_launcher_crash_resume_on_the_card(dev, tmp_path, monkeypatch):
    """``launch/train.py`` on the card at smollm-135m-smoke widened to a
    flash pair (head_dim 64, bf16): 6 steps uninterrupted, then a run
    that exits 42 after step 3 with a checkpoint at step 4, then its
    resume; the crashed run's losses and the resumed ones equal the
    uninterrupted run's bit for bit.  Each step launches the flash
    forward once a layer and its backward once a layer, on the tensor
    cores."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    cfg = dataclasses.replace(get_config("smollm-135m-smoke"), head_dim=64)
    monkeypatch.setattr(train, "get_config", lambda arch: cfg)
    args = ["--arch", "smollm-135m-smoke", "--steps", "6", "--batch", "4",
            "--seq", "64", "--log-every", "50"]
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    kernels.reset_launches()
    ref = train.main(args)
    counts = kernels.launch_counts()
    per_step = {"flash_attention": cfg.num_layers,
                "flash_attention_bwd": cfg.num_layers,
                "flash_attention_bwd_tc": cfg.num_layers}
    assert {k: counts[k] for k in per_step} == \
        {k: 6 * n for k, n in per_step.items()}, counts
    assert all(np.isfinite(ref)) and ref[-1] < ref[0]
    crashed = {}
    with pytest.raises(SystemExit) as exit_:
        train.main(args + ck + ["--fail-at", "3"], crashed)
    assert exit_.value.code == 42
    assert [l for _, l, _ in crashed["steps"]] == ref[:4]
    resumed = {}
    assert train.main(args + ck, resumed) == ref[4:]
    assert resumed["start"] == 4


# ------------------------------------------- the static analysis on the card


def test_analysis_card_grid_is_green(dev):
    """``run_contracts("card")``: every hot path on CUDA at world 1 (NCCL)
    within the port's declared counts, no violation."""
    from repro_torch.analysis import contracts
    viol, recs, _ = contracts.run_contracts("card")
    assert viol == [], "\n".join(v.format() for v in viol)
    twin = next(r for r in recs if r["hot_path"].startswith("lp_kernel."))
    assert twin["pivots"] > 0
    assert twin["host_reads_per_pivot"] == 1.0
    assert twin["pricing_launches_per_pivot"] == 1.0
    assert twin["select_calls_per_pivot"] == 1.0
    pq = next(r for r in recs if r["hot_path"].startswith(
        "distributed.pq_step"))
    assert pq["pricing_launches_per_pivot"] == 1.0
    assert int(pq["dense_passes"]) == contracts.PQ_PASSES


@pytest.mark.parametrize("n", [3000, 10000])
def test_device_lp_pivot_is_one_read_and_one_pricing_launch(dev, n):
    """Each pivot of ``solve_lp_kernel`` on the card: exactly one host
    read (the declared one), one pricing launch, one select call -- of
    one select kernel up to ``ONE_CTA_MAX`` columns, three above."""
    from repro_torch.analysis import contracts
    from repro_torch.core.lp_kernel import solve_lp_kernel
    from repro_torch.kernels.bfrt import ONE_CTA_MAX
    lp = contracts.package_lp(n, 8, seed=3)
    with contracts.OpTrace(dev) as tr:
        res = solve_lp_kernel(*lp, device=dev)
    P = tr.pivots["lp_kernel._solve"]
    assert P == res.iters > 0
    reads = [r for r in tr.reads if r.hot is not None]
    assert [r.pivot for r in reads] == list(range(1, P + 1))
    assert all(r.site.func == "_solve.<locals>.read" for r in reads)
    price, launched, sel = tr.launches_per_pivot()
    assert price == [1] * P
    assert sel == [1] * P
    assert launched == [1 if n + 8 <= ONE_CTA_MAX else 3] * P
