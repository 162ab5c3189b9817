"""The DLV scan's long path (speculate, verify, repair) on the CPU.

``kernels.dlv_scan.long_scan_plain`` is the loop that the long path of
``csrc/dlv_scan.cu`` runs in each CTA, in plain torch.  Its cuts must be
the compensated scan's bit for bit, whatever the speculation guessed:
held here against ``scan_cols_plain`` (the kernel's arithmetic) and the
reference's float64 ``_dlv_scan_np`` and x64 ``_dlv_scan_cols``, on long
segments, on deliberately wrong guesses, and on a near-tie that the
division-free speculative test and the compensated test decide
differently.  Small tiles (``tile=``) make a few thousand rows cross many
tile edges; a small ``cap`` makes the speculation buffer fill.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dlv as ref_dlv
from repro_torch.kernels import dlv_scan

F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _compensated(v: np.ndarray, beta: float) -> np.ndarray:
    return dlv_scan.scan_cols_plain(_t(v[:, None]), _t([beta]))[:, 0].numpy()


def _segment(kind: str, n: int, seed: int):
    """A sorted, mean-centred segment and its bar (the build's rule,
    13.5 var / d_f^2), in one of the shapes the tests need."""
    rng = np.random.default_rng(seed)
    if kind.startswith("mag"):                 # wide magnitudes, as in the
        v = np.sort(rng.normal(float(kind[3:]), 1.0, n))   # reference test
    elif kind == "dups":                       # a few hundred distinct values
        v = np.sort(np.round(rng.normal(0.0, 3.0, n), 1))
    else:
        v = np.sort(rng.lognormal(0.0, 0.55, n))
    v = v - v.mean()
    return v, 13.5 * np.var(v) / 100 ** 2


@pytest.mark.parametrize("kind,beta_scale", [
    ("mag1e6", 1.0), ("mag3e7", 1.0), ("dups", 1.0), ("lognormal", 1.0),
    ("lognormal", 1e-12), ("lognormal", 1e9)])
@pytest.mark.parametrize("tile", [256, dlv_scan.TILE])
def test_long_path_is_the_compensated_scan(kind, beta_scale, tile):
    """Bit-equal to the compensated scan and the reference's float64 scans;
    beta 1e-12 of the build's bar cuts almost every row, 1e9 times it cuts
    none."""
    v, beta = _segment(kind, 4000, seed=len(kind))
    beta *= beta_scale
    want = ref_dlv._dlv_scan_np(v, beta)
    if beta_scale < 1:
        assert want.sum() > 0.9 * len(v)
    elif beta_scale > 1:
        assert want.sum() == 0
    else:
        assert want.sum() > 10
    got = dlv_scan.long_scan_plain(_t(v), beta, tile=tile,
                                   cap=64 if beta_scale < 1 else 4096)
    np.testing.assert_array_equal(got.numpy(), _compensated(v, beta))
    np.testing.assert_array_equal(got.numpy(), want)
    jax64 = np.asarray(ref_dlv._dlv_scan_cols(jnp.asarray(v[:, None]),
                                              jnp.asarray([beta])))[:, 0]
    np.testing.assert_array_equal(got.numpy(), jax64)


def _wrong(true: np.ndarray, how: str, L: int, rng) -> np.ndarray:
    if how == "shift+1":
        s = true + 1
    elif how == "shift-1":
        s = true - 1
    elif how == "missing":
        s = true[::2]
    elif how == "added":
        s = np.concatenate([true, (true[:-1] + true[1:]) // 2])
    elif how == "random":
        s = rng.integers(1, L, 3 * len(true))
    else:                                       # "none"
        s = np.zeros(0, np.int64)
    return np.unique(s[(s >= 1) & (s < L)])


@pytest.mark.parametrize("how", ["shift+1", "shift-1", "missing", "added",
                                 "random", "none"])
def test_repair_returns_the_compensated_cuts(how):
    """A deliberately wrong guess in place of the first speculation (what
    the kernel's ``init_spec`` takes): the repair still ends at exactly the
    compensated cuts, and it did repair."""
    v, beta = _segment("lognormal", 3000, seed=7)
    want = _compensated(v, beta)
    true = np.flatnonzero(want)
    assert len(true) > 10
    spec = _wrong(true, how, len(v), np.random.default_rng(1))
    stats = {}
    got = dlv_scan.long_scan_plain(_t(v), beta, spec=spec, tile=512,
                                   stats=stats)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats["repairs"] >= 1
    cuts, counters = dlv_scan.verify_speculation(_t(v), beta, spec)
    np.testing.assert_array_equal(cuts.numpy(), want)
    assert int(counters[dlv_scan.STAT_NAMES.index("repairs")]) >= 1


def test_verify_speculation_rejects_a_malformed_guess():
    v = _t(np.linspace(-1, 1, 100))
    for spec in ([5, 3], [0, 4], [4, 100], [7, 7]):
        with pytest.raises(ValueError):
            dlv_scan.verify_speculation(v, 1e-3, spec)


def _running_variances(v: np.ndarray) -> np.ndarray:
    """The compensated scan's running variance at every row, from row 0
    with no restart (``scan_cols_plain``'s operations, in numpy)."""
    k = s1 = c1 = s2 = c2 = 0.0
    out = np.empty(len(v))
    for i, x in enumerate(v):
        k1 = k + 1.0
        x2 = x * x
        y1 = x - c1
        t1 = s1 + y1
        c1 = (t1 - s1) - y1
        y2 = x2 - c2
        t2 = s2 + y2
        c2 = (t2 - s2) - y2
        mean = t1 / k1
        out[i] = t2 / k1 - mean * mean
        k, s1, s2 = k1, t1, t2
    return out


def test_near_tie_speculation_disagrees_and_is_repaired():
    """beta set to a row's compensated running variance (and a few ulps
    around it): find a bar at which the division-free speculative test
    picks another first cut than the compensated test; the long path still
    returns the compensated cuts, through a repair."""
    v, _ = _segment("lognormal", 2000, seed=3)
    var = _running_variances(v)
    vt = _t(v)
    found = None
    for r in range(50, 1500, 7):
        for beta in (var[r], np.nextafter(var[r], np.inf),
                     np.nextafter(var[r], -np.inf)):
            spec, _ = dlv_scan._speculate_plain(vt, float(beta), 0, 1, 512, 1)
            comp = int(np.argmax(var[1:] > beta)) + 1
            if spec and spec[0] != comp:
                found = float(beta)
                break
        if found is not None:
            break
    assert found is not None, "no near-tie where the two tests disagree"
    stats = {}
    got = dlv_scan.long_scan_plain(vt, found, tile=512, stats=stats)
    np.testing.assert_array_equal(got.numpy(), _compensated(v, found))
    np.testing.assert_array_equal(got.numpy(), ref_dlv._dlv_scan_np(v, found))
    assert stats["repairs"] >= 1


def test_cpu_scan_reports_no_long_path_work(monkeypatch):
    """On a CPU tensor ``dlv_scan`` runs the plain version; its counters
    are zeros and the cuts those of the plain version."""
    v, beta = _segment("lognormal", 3000, seed=5)
    monkeypatch.setattr(dlv_scan, "LONG_MIN", 1000)
    cuts, st = dlv_scan.dlv_scan(_t(v), np.array([3000]), np.array([beta]),
                                 stats=True)
    assert st.tolist() == [0] * len(dlv_scan.STAT_NAMES)
    np.testing.assert_array_equal(cuts.numpy(), ref_dlv._dlv_scan_np(v, beta))
