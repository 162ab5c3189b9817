"""The heap-built DLV and the seed scan of the port against the JAX
reference, on the CPU.

``dlv(method="heap")`` (``dlv_heap``) runs the reference's host loop line
for line, each pop's scan through ``dlv_1d`` (the reference's host scan
path on the CPU) or, with ``scan="seed"``, ``dlv_1d_seed``.  So on the
CPU its partitions are the reference's exactly: order, offsets, gids and
the split tree's arrays.  The seed scan's plain version rounds as the
reference's compiled scan does (one fused multiply-add in the variance),
so its cuts equal the reference's also where a running variance lies
within an ulp of beta.  The kernel itself is held on the card
(``tests/test_torch_cuda.py -k seed``, ``chip_smoke.py``).
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (jax x64, as the reference runs)
import jax.numpy as jnp
from repro.core import dlv as ref_dlv
from repro.core import partitioner as ref_partitioner
from repro_torch.core import dlv, partitioner
from repro_torch.kernels import dlv_scan as kdlv

TREE = ("attr", "bound_off", "bounds", "children", "root")


def _same_partition(a, b):
    for f in ("order", "offsets", "gid"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    for f in TREE:
        np.testing.assert_array_equal(getattr(a.tree, f), getattr(b.tree, f),
                                      err_msg=f"tree.{f}")
    for f in ("reps", "boxes_lo", "boxes_hi"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


@pytest.fixture(scope="module")
def X():
    """``tests/test_partitioner.py``'s fixture."""
    rng = np.random.default_rng(7)
    return np.concatenate([
        rng.normal(0, 1, (9000, 3)),
        rng.normal(7, 2, (9000, 3)),
    ]) * np.array([1.0, 4.0, 0.3])


@pytest.fixture(scope="module")
def heaps(X):
    return (ref_dlv.dlv(X, 60, method="heap"),
            dlv.dlv(X, 60, method="heap", device="cpu"))


def test_heap_build_equals_the_reference(heaps):
    ref, got = heaps
    assert got.num_groups == ref.num_groups >= 60
    _same_partition(ref, got)


def test_heap_descent_agrees_with_gid(heaps, X):
    _, got = heaps
    idx = np.random.default_rng(0).choice(len(X), 2000, replace=False)
    np.testing.assert_array_equal(got.get_group_batch(X[idx]), got.gid[idx])
    np.testing.assert_array_equal(
        got.get_group_batch(X[idx], jit=True, device="cpu"), got.gid[idx])


@pytest.mark.parametrize("kw", [dict(min_groups=50),
                                dict(c=np.array([8.0, 13.5, 20.0])),
                                dict(rng=np.random.default_rng(5)),
                                dict(chunk_rows=1000)],
                         ids=["min_groups", "c", "rng", "chunk_rows"])
def test_heap_build_options_equal_the_reference(X, kw):
    Xs = X[::3]
    ref = ref_dlv.dlv_heap(Xs, 40, **dict(kw))
    if "rng" in kw:
        kw = dict(kw, rng=np.random.default_rng(5))
    got = dlv.dlv_heap(Xs, 40, device="cpu", **kw)
    _same_partition(ref, got)


def test_duplicate_heavy_heap_build():
    """``tests/test_partitioner.py``'s duplicate-heavy case: mostly ties,
    cuts snapped to run starts, the descent equal to gid."""
    rng = np.random.default_rng(11)
    X = np.repeat(rng.normal(size=(50, 2)), 20, axis=0)
    ref = ref_dlv.dlv(X, 10, method="heap", rng=np.random.default_rng(0))
    got = dlv.dlv(X, 10, method="heap", rng=np.random.default_rng(0),
                  device="cpu")
    _same_partition(ref, got)
    np.testing.assert_array_equal(got.get_group_batch(X), got.gid)


def test_heap_and_fit_give_one_partition(X):
    """``dlv(method="heap")`` and ``partitioner.fit(..., method="heap")``
    forward every option to ``dlv_heap``, as the reference's do."""
    Xs = X[::4]
    a = dlv.dlv(Xs, 30, method="heap", device="cpu")
    b = partitioner.fit(Xs, backend="dlv", d_f=30, method="heap",
                        device="cpu")
    c = dlv.dlv_heap(Xs, 30, device="cpu")
    _same_partition(a, b)
    _same_partition(a, c)
    _same_partition(ref_partitioner.fit(Xs, backend="dlv", d_f=30,
                                        method="heap"), b)
    with pytest.raises(TypeError):
        dlv.dlv(Xs, 30, method="heap", device="cpu", no_such_option=1)


def test_zero_time_budget_raises_in_both(X):
    with pytest.raises(TimeoutError, match="exceeded 0s"):
        ref_dlv.dlv_heap(X, 60, time_budget_s=0)
    with pytest.raises(TimeoutError, match="exceeded 0s"):
        dlv.dlv_heap(X, 60, time_budget_s=0, device="cpu")


def test_heap_mesh_names_item_6(X):
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue 1, item 6"):
        dlv.dlv_heap(X[:500], 10, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue 1, item 6"):
        dlv.dlv(X[:500], 10, method="heap", mesh=object(), device="cpu")


def test_heap_seed_build_equals_the_reference():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(400, 2)) * np.array([1.0, 5.0])
    ref = ref_dlv.dlv_heap(X, 40, scan="seed")
    got = dlv.dlv_heap(X, 40, scan="seed", device="cpu")
    assert got.num_groups == ref.num_groups
    _same_partition(ref, got)


# ------------------------------------------------------------ the seed scan


@pytest.mark.parametrize("L", [1, 2, 7, 64, 333])
def test_dlv_1d_seed_equals_the_reference(L):
    rng = np.random.default_rng(L)
    for _ in range(6):
        v = np.sort(rng.normal(size=L) * rng.uniform(0.1, 10)
                    + rng.uniform(-100, 100))
        beta = float(np.var(v)) * rng.uniform(0.001, 0.5)
        got = dlv.dlv_1d_seed(v, beta, device="cpu")
        want = ref_dlv.dlv_1d_seed(v, beta)
        assert got.dtype == bool and not got[0]
        np.testing.assert_array_equal(got, want)
    assert dlv.dlv_1d_seed(np.zeros(0), 1.0, device="cpu").shape == (0,)


def _running_vars(v, beta):
    """The seed scan's running variance at every row (the reference's
    rounding), and its cuts, by exact rationals."""
    k = s1 = s2 = 0.0
    out = []
    for x in v:
        k1 = k + 1.0
        s1n, s2n = s1 + x, s2 + x * x
        m = s1n / k1
        var = float(Fraction(s2n / k1) - Fraction(m) * Fraction(m))
        out.append(var)
        if var > beta:
            k, s1, s2 = 1.0, x, x * x
        else:
            k, s1, s2 = k1, s1n, s2n
    return out


def _unfused(v, beta):
    """The seed scan with s2/k - m*m rounded twice (no fused op)."""
    k = s1 = s2 = 0.0
    out = []
    for x in v:
        k1 = k + 1.0
        s1n, s2n = s1 + x, s2 + x * x
        m = s1n / k1
        cut = s2n / k1 - m * m > beta
        out.append(cut)
        k, s1, s2 = (1.0, x, x * x) if cut else (k1, s1n, s2n)
    return np.array(out)


@pytest.mark.parametrize("L", [5, 64])
def test_seed_scan_plain_equals_the_reference_at_near_ties(L):
    """Betas set to a running variance and to the floats either side of
    it: the plain version's cuts equal the reference's compiled scan on
    every span, and on some of them the unfused rounding would cut
    elsewhere (so the spans do reach the rounding)."""
    rng = np.random.default_rng(100 + L)
    unfused_differs = 0
    for _ in range(40):
        v = np.sort(rng.normal(size=L) * rng.uniform(0.1, 10)
                    + rng.uniform(-100, 100))
        v = v - v.mean()
        b0 = float(np.var(v)) * rng.uniform(0.01, 0.5)
        r = int(rng.integers(1, L))
        var_r = _running_vars(v, b0)[r]
        for beta in (var_r, np.nextafter(var_r, -np.inf),
                     np.nextafter(var_r, np.inf)):
            want = np.asarray(ref_dlv._dlv_scan_seed(jnp.asarray(v),
                                                     jnp.asarray(beta)))
            got = kdlv.dlv_scan_seed_plain(torch.as_tensor(v), beta)
            np.testing.assert_array_equal(got.numpy(), want)
            assert torch.equal(kdlv.dlv_scan_seed(torch.as_tensor(v), beta),
                               got)
            unfused_differs += not np.array_equal(_unfused(v, beta), want)
    assert unfused_differs > 0


def test_seed_scan_wrapper_runs_plain_on_the_cpu_only():
    v = torch.as_tensor(np.sort(np.random.default_rng(1).normal(size=300)))
    before = kdlv.seed_launches
    got = kdlv.dlv_scan_seed(v - v.mean(), 0.05)
    assert kdlv.seed_launches == before           # no launch on the CPU
    assert got.dtype == torch.bool and got.shape == (300,)
    assert int(got.sum()) > 0
