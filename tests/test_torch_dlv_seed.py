"""The certified seed scan on the CPU.

``kernels.dlv_scan.seed_scan_certified_plain`` is the design that
``dlv_scan_seed`` launches on a CUDA tensor (``csrc/dlv_scan.cu``: prefix
sums, a walk that decides each row by a proven rounding band, the
reference's serial chain at near-ties), in plain torch with the same
tiles, band, order of additions and counters.  Its cuts must be
``dlv_scan_seed_plain``'s bit for bit on every input: held here on random
sorted spans, near-ties (beta at a running variance and one ulp to each
side), duplicate-heavy, shifted and unsorted spans, bad betas and
non-finite values, at several tile sizes, and against the reference's
jitted ``_dlv_scan_seed`` on short spans.  The band itself is checked
against exact rationals on random windows.  The card runs the same
comparisons against the kernel (``tests/test_torch_cuda.py -k seed``).
"""
import math
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dlv as ref_dlv
from repro_torch.kernels import dlv_scan

F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _held(v, beta, **kw):
    """The mirror's cuts against the plain version's (bit-equal); returns
    its counters."""
    st = {}
    got = dlv_scan.seed_scan_certified_plain(_t(v), beta, stats=st, **kw)
    want = dlv_scan.dlv_scan_seed_plain(_t(v), beta)
    assert torch.equal(got, want), (len(v), beta)
    assert st["windows"] == (int(want[1:].sum()) + 1 if len(v) else 0)
    return st


def _span(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = np.sort(rng.normal(rng.uniform(-1e3, 1e3), 2.0, n))
    return v - v.mean()


@pytest.mark.parametrize("n", [1, 2, 3, 16, 17, 1000, 20_000])
def test_certified_scan_equals_the_plain_scan(n):
    v = _span(n, n)
    beta = 13.5 * v.var() / 100 ** 2 if n > 1 else 0.0
    st = _held(v, beta, rows=16, blocks=16, block=8)
    if n >= 1000:
        assert st["windows"] > 10


def test_a_normal_span_steps_under_one_percent_serially():
    """The fixed span's shape (normal, sigma 2, beta 13.5 var / 100^2) at
    the kernel's geometry: the band decides almost every row (the serial
    rows are the tails' short windows), and a window costs a few tests."""
    rng = np.random.default_rng(5)
    v = np.sort(rng.normal(0.0, 2.0, 100_000))
    v = v - v.mean()
    st = _held(v, 13.5 * v.var() / 100 ** 2)
    assert st["serial_rows"] < 0.01 * len(v)
    assert st["windows"] > 10
    assert st["tests"] < 3 * st["windows"]


def _var_from_zero(v):
    """The reference's running variance from row 0 without a restart,
    rounded as its compiled scan rounds (one fused rounding, exact
    rationals here)."""
    k = s1 = s2 = 0.0
    out = []
    for x in v:
        k += 1.0
        s1 += x
        s2 += x * x
        m = s1 / k
        out.append(float(Fraction(s2 / k) - Fraction(m) * Fraction(m)))
    return out


@pytest.mark.parametrize("kind", ["lognormal", "normal"])
def test_near_ties_take_the_serial_chain(kind):
    """beta at the running variance of a row that no earlier row of the
    first window reaches, and one ulp to each side: the row's decision
    lies inside the band, so the walk runs the reference's chain there
    (near-ties > 0), and the cuts stay the plain version's."""
    rng = np.random.default_rng(9)
    v = np.sort(rng.lognormal(0.0, 0.55, 1500) if kind == "lognormal"
                else rng.normal(0.0, 1.0, 1500))
    v = v - v.mean()
    var = _var_from_zero(v)
    records, best = [], -math.inf
    for i, x in enumerate(var[1:], 1):
        if x > best:
            records.append(i)
            best = x
    rows = records[3::max(1, len(records) // 6)][:6]
    assert len(rows) >= 5
    for r in rows:
        for beta in (var[r], np.nextafter(var[r], np.inf),
                     np.nextafter(var[r], -np.inf)):
            st = _held(v, float(beta), rows=8, blocks=8, block=4)
            assert st["near_ties"] > 0, (r, beta)


@pytest.mark.parametrize("beta_scale", [1.0, 0.0, 1e-9])
def test_duplicate_heavy_spans(beta_scale):
    """A few hundred distinct values: flat variances inside runs; at beta
    0 nearly every row is a near-tie, and still exact."""
    rng = np.random.default_rng(3)
    v = np.sort(np.round(rng.normal(0.0, 3.0, 4000), 1))
    v = v - v.mean()
    _held(v, beta_scale * 13.5 * v.var() / 100 ** 2, rows=16, blocks=8,
          block=8)


@pytest.mark.parametrize("shift", [1e4, 1e8, -3e6])
def test_shifted_spans(shift):
    """Spans far from zero (not centred): m^2 >> var in every window, the
    band widens with m^2 and more rows take the serial chain."""
    rng = np.random.default_rng(4)
    v = np.sort(rng.normal(shift, 1.0, 2500))
    _held(v, 13.5 * v.var() / 100 ** 2, rows=8, blocks=8, block=4)


@pytest.mark.parametrize("beta", [0.0, -1.0, 1e-300, math.nan, math.inf,
                                  -math.inf])
def test_bad_betas(beta):
    v = _span(300, 1)
    _held(v, beta, rows=4, blocks=4, block=4)


@pytest.mark.parametrize("where", ["nan", "inf", "-inf", "ends"])
def test_non_finite_values(where):
    v = np.sort(np.random.default_rng(2).normal(0.0, 1.0, 300))
    if where == "ends":
        v[0], v[-1] = -np.inf, np.inf
    else:
        v[120] = float(where)
    _held(v, 1e-3, rows=4, blocks=4, block=4)


def test_an_unsorted_span():
    rng = np.random.default_rng(6)
    v = rng.normal(0.0, 1.0, 3000)
    for beta in (0.5, 1.0, 2.0):
        _held(v, beta, rows=8, blocks=8, block=4)


@pytest.mark.parametrize("scan,rows,blocks,block,short", [
    ((32, 2), 1, 8, 1, 32), ((64, 4), 8, 8, 4, 1), ((32, 16), 32, 16, 16, 32),
    ((512, 8), 256, 256, 128, 0), ((512, 8), 256, 256, 128, 1000)])
def test_walk_geometries(scan, rows, blocks, block, short):
    """Prefix-pass geometries (threads, rows a thread) and walk geometries
    (rows tested one by one, blocks and rows a block a test; after a
    window shorter than ``short`` rows the chain decides: never, always,
    or as the kernel) that put a few thousand rows across many tile
    edges."""
    rng = np.random.default_rng(block)
    v = np.sort(rng.lognormal(0.0, 0.55, 6000))
    v = v - v.mean()
    st = _held(v, 13.5 * v.var() / 100 ** 2, scan=scan, rows=rows,
               blocks=blocks, block=block, short=short)
    if short == 0:
        assert st["short_runs"] == 0
    if short == 1000:             # one chain from the first cut on
        assert st["short_runs"] == 1 and st["tests"] <= 2
        assert st["serial_rows"] >= len(v) - 1000


def test_prefix_order_is_fixed():
    """The prefix pass's double-doubles are the kernel's order of
    additions: each tile's rows from its base, that base the tile totals'
    scan.  Checked as the sums it must approximate: every prefix within
    the proof's bound (3.01 u^2 (n + 2) sum|x|) of the exact one."""
    rng = np.random.default_rng(8)
    v = rng.normal(0.0, 1.0, 3000) * 10.0 ** rng.integers(-3, 4, 3000)
    P = dlv_scan._seed_prefix_plain(_t(v), 32, 4)
    exact1, exact2 = Fraction(0), Fraction(0)
    absum = sum(Fraction(abs(x)) for x in v)
    sqsum = sum(Fraction(x * x) for x in v)
    u2 = Fraction(1, 2 ** 106)
    for i, x in enumerate(v):
        exact1 += Fraction(x)
        exact2 += Fraction(x * x)
        if i % 97 == 0 or i == len(v) - 1:
            p1 = Fraction(float(P[0][i])) + Fraction(float(P[1][i]))
            p2 = Fraction(float(P[2][i])) + Fraction(float(P[3][i]))
            assert abs(p1 - exact1) <= Fraction(301, 100) * u2 * \
                (len(v) + 2) * absum
            assert abs(p2 - exact2) <= Fraction(301, 100) * u2 * \
                (len(v) + 2) * sqsum


def _chain(v, j: int, i: int):
    """The reference's running sums over rows j..i (restart state at j)
    and its value var_ref(j, i), exactly rounded once."""
    k, s1, s2 = 1.0, v[j], v[j] * v[j]
    for r in range(j + 1, i + 1):
        k += 1.0
        s1 += v[r]
        s2 += v[r] * v[r]
    m = s1 / k
    return float(Fraction(s2 / k) - Fraction(m) * Fraction(m))


def _band_spans():
    rng = np.random.default_rng(11)
    out = []
    v = np.sort(rng.normal(0.0, 2.0, 3000))
    out.append(v - v.mean())
    out.append(np.sort(rng.normal(1e6, 1.0, 2000)))          # m^2 >> var
    v = np.sort(np.round(rng.normal(0.0, 3.0, 2000), 1))
    out.append(v - v.mean())                                 # duplicates
    out.append(rng.normal(0.0, 1.0, 2000) * 1e-158)          # x*x underflows
    out.append(rng.normal(0.0, 1.0, 2000) * 1e150)           # huge
    v = np.sort(rng.lognormal(0.0, 1.5, 2000))
    out.append(v - v.mean())                                 # long tail
    return out


def test_the_band_bounds_the_reference_against_exact_rationals():
    """On 240 random windows (j, i), k = 1 to ~1,000 rows, of spans that
    are centred, shifted far from zero, duplicate-heavy, tiny (x*x below
    the normal range), huge and long-tailed: the reference's serial value
    var_ref(j, i), exactly rounded, lies within the band Wd of the
    estimate d / k^2 (|k^2 var_ref - d| <= Wd, in rationals), and the
    walk's classification of each beta near it is the reference's
    decision wherever it is not "uncertain"."""
    rng = np.random.default_rng(12)
    worst = 0.0
    n_windows = 0
    for v in _band_spans():
        n = len(v)
        P = dlv_scan._seed_prefix_plain(_t(v))
        bounds = dlv_scan._seed_bounds(float(P[2][-1]), n)
        x = v.tolist()
        for w in range(40):
            j = int(rng.integers(0, n))
            k = 1 if w < 3 else int(min(n - j, rng.integers(1, 1000)))
            i = j + k - 1
            var_ref = _chain(x, j, i)
            a = [float(q[j - 1]) if j else 0.0 for q in P]
            s1 = (float(P[0][i]) - a[0]) + (float(P[1][i]) - a[1])
            s2 = (float(P[2][i]) - a[2]) + (float(P[3][i]) - a[3])
            d, _, _, wd, _ = dlv_scan._seed_band_terms(
                s1, s2, float(k), 0.0, bounds)
            err = abs(Fraction(k) ** 2 * Fraction(var_ref) - Fraction(d))
            assert err <= Fraction(wd), (n, j, k, var_ref, d, wd)
            worst = max(worst, float(err / Fraction(wd)))
            n_windows += 1
            rows = torch.tensor([i])
            pa = tuple(torch.tensor(q, dtype=F64) for q in a)
            for beta in (var_ref, np.nextafter(var_ref, np.inf),
                         np.nextafter(var_ref, -np.inf), 1.001 * var_ref,
                         0.999 * var_ref):
                cls = int(dlv_scan._seed_classify_plain(
                    P, pa, rows, j, float(beta), bounds)[0])
                if cls == 0:
                    assert not var_ref > beta
                elif cls == 1:
                    assert var_ref > beta
    assert n_windows >= 200 and worst < 1.0


def _chain_vars(v, j: int, i: int):
    """var_ref(j, r) for every row r = j..i, as ``_chain`` gives each."""
    k, s1, s2 = 1.0, v[j], v[j] * v[j]
    out = [float(Fraction(s2 / k) - Fraction(s1 / k) ** 2)]
    for r in range(j + 1, i + 1):
        k += 1.0
        s1 += v[r]
        s2 += v[r] * v[r]
        m = s1 / k
        out.append(float(Fraction(s2 / k) - Fraction(m) * Fraction(m)))
    return out


def test_the_block_test_bounds_every_row_against_exact_rationals():
    """The walk's block test (rows a..b of the window from j, ka < kb,
    the bar beta*ka*kb against the estimate at b): wherever it says
    "every row surely no cut", every row's exact var_ref(j, r) is <= beta.
    On 240 random blocks of the band test's spans, with beta at the
    block's largest var_ref and one ulp to each side, and at the bar's
    edge kb/ka * var_ref(j, b) and one ulp to each side, and 2^-36 and
    1e-3 above it (where it clears the block on the centred, duplicate,
    huge and long-tailed spans; the shifted and tiny spans' bands are
    wider than that)."""
    rng = np.random.default_rng(13)
    n_blocks, clear = 0, []
    for v in _band_spans():
        clear.append(0)
        n = len(v)
        P = dlv_scan._seed_prefix_plain(_t(v))
        bounds = dlv_scan._seed_bounds(float(P[2][-1]), n)
        x = v.tolist()
        for _ in range(40):
            j = int(rng.integers(0, n - 3))
            ka = int(rng.integers(2, min(n - j - 1, 1000) + 1))
            kb = int(rng.integers(ka + 1, min(n - j, ka + 128) + 1))
            a, b = j + ka - 1, j + kb - 1
            var = _chain_vars(x, j, b)[ka - 1:]
            top = max(var)
            edge = kb / ka * var[-1]
            pa = tuple(torch.tensor(float(q[j - 1]) if j else 0.0,
                                    dtype=F64) for q in P)
            for beta in (top, np.nextafter(top, np.inf),
                         np.nextafter(top, -np.inf), edge,
                         np.nextafter(edge, np.inf),
                         np.nextafter(edge, -np.inf),
                         (1.0 + 2.0 ** -36) * abs(edge), 1.001 * abs(edge)):
                cls = int(dlv_scan._seed_classify_plain(
                    P, pa, torch.tensor([b]), j, float(beta), bounds,
                    starts=torch.tensor([a]))[0])
                if cls == 0:
                    assert all(not r > beta for r in var), (n, j, ka, kb)
                    clear[-1] += 1
            n_blocks += 1
    assert n_blocks >= 200 and sum(clear) >= 200
    assert all(clear[s] >= 40 for s in (0, 2, 4, 5)), clear


@pytest.mark.parametrize("n", [5, 33, 64])
def test_short_spans_equal_the_reference(n):
    """The mirror against the reference's jitted ``_dlv_scan_seed``
    itself (raw flags, row 0 included), at the build's bar and at a
    running variance and one ulp below it."""
    v = _span(n, 100 + n)
    var = _var_from_zero(v)
    for beta in (13.5 * v.var() / 10 ** 2, var[n // 2],
                 np.nextafter(var[n // 2], -np.inf)):
        want = np.asarray(ref_dlv._dlv_scan_seed(jnp.asarray(v),
                                                 jnp.asarray(beta)))
        got = dlv_scan.seed_scan_certified_plain(_t(v), float(beta),
                                                 rows=2, blocks=4, block=2)
        np.testing.assert_array_equal(got.numpy(), want)


def test_the_wrapper_on_the_cpu():
    """On a CPU tensor ``dlv_scan_seed`` runs the plain version, counts no
    launch, and its counters are zeros (``serial`` too)."""
    v = _t(_span(500, 7))
    before = (dlv_scan.seed_launches, dlv_scan.seed_serial_launches)
    cuts, st = dlv_scan.dlv_scan_seed(v, 0.05, stats=True)
    assert torch.equal(cuts, dlv_scan.dlv_scan_seed_plain(v, 0.05))
    assert st.tolist() == [0] * len(dlv_scan.SEED_STAT_NAMES)
    assert torch.equal(dlv_scan.dlv_scan_seed(v, 0.05, serial=True), cuts)
    assert (dlv_scan.seed_launches,
            dlv_scan.seed_serial_launches) == before
