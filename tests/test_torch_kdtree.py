"""The KD-tree baseline partitioner, 1-D DLV and ``ratio_score`` of the
port against the JAX reference, on the CPU.

``kdtree_partition`` is host numpy in both packages: gids, order, offsets
and the split tree must be equal, reps and boxes within 1e-12.
``dlv_1d`` runs the port's DLV scan (its plain version here) and must
place the reference's cuts exactly.  The reference's own bars
(``tests/test_dlv.py``: Theorems 1 and 2, DLV beating KD-tree) must hold
on the port.
"""
import numpy as np
import pytest

from repro.core import dlv as ref_dlv
from repro.core import kdtree as ref_kdtree
from repro.core import partitioner as ref_partitioner
from repro_torch.core import dlv, kdtree, partitioner

TREE_FIELDS = ("attr", "bound_off", "bounds", "children")


def _blobs(n=6000, seed=7):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(0, 1, (n // 2, 3)),
                           rng.normal(7, 2, (n - n // 2, 3))]) \
        * np.array([1.0, 4.0, 0.3])


def _same_partition(got, want, tol=1e-12):
    np.testing.assert_array_equal(got.gid, want.gid)
    np.testing.assert_array_equal(got.order, want.order)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(got.tree, f),
                                      getattr(want.tree, f))
    assert got.tree.root == want.tree.root
    for f in ("reps", "boxes_lo", "boxes_hi"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=tol, atol=0)


@pytest.mark.parametrize("tau, omega", [(2, np.inf), (25, np.inf),
                                        (60, 1.5), (500, 0.5),
                                        (10_000, np.inf)])
def test_kdtree_matches_reference(tau, omega):
    X = _blobs()
    _same_partition(kdtree.kdtree_partition(X, tau=tau, omega=omega),
                    ref_kdtree.kdtree_partition(X, tau=tau, omega=omega))


@pytest.mark.parametrize("X", [np.ones((300, 2)), np.full((301, 2), 0.1)],
                         ids=["all-equal", "all-equal-rounded-mean"])
def test_kdtree_degenerate_split_matches_reference(X):
    """A cluster whose split would leave one side empty is finalised."""
    got = kdtree.kdtree_partition(X, tau=4)
    _same_partition(got, ref_kdtree.kdtree_partition(X, tau=4))
    assert got.num_groups == 1 and got.tree.num_nodes == 0


def test_kdtree_backend_through_fit_matches_reference():
    X = _blobs(4000, seed=1)
    got = partitioner.fit(X, backend="kdtree", d_f=40, device="cpu")
    _same_partition(got, ref_partitioner.fit(X, backend="kdtree", d_f=40))
    T = X[np.random.default_rng(2).choice(len(X), 500)]
    np.testing.assert_array_equal(got.get_group_batch(T),
                                  np.fromiter((got.get_group(t) for t in T),
                                              np.int64, len(T)))
    assert set(partitioner.available_backends()) >= {"dlv", "kdtree",
                                                     "bucketing"}
    with pytest.raises(TypeError, match="mesh/chunk_rows"):
        partitioner.fit(X, backend="kdtree", d_f=40, chunk_rows=100,
                        device="cpu")
    with pytest.raises(TypeError, match="mesh/chunk_rows"):
        partitioner.fit(X, backend="kdtree", d_f=40, mesh=object(),
                        device="cpu")
    assert kdtree.KDResult is partitioner.Partition


@pytest.mark.parametrize("weighted", [False, True])
def test_ratio_score_matches_reference(weighted):
    rng = np.random.default_rng(9)
    vals = rng.normal(size=2000)
    dense = rng.integers(0, 20, 2000)
    remap = np.array([-7, 3, 10**6, 55, -1, 17, 999_999, 123456, 42, 8,
                      -100, 7_000_000, 31, 2, 900_000, 64, -3, 5, 77, 88])
    for gid in (dense, remap[dense], remap[dense].astype(np.float64)):
        got = dlv.ratio_score(vals, gid, weighted=weighted)
        want = ref_dlv.ratio_score(vals, gid, weighted=weighted)
        assert got == pytest.approx(want, rel=1e-12, abs=1e-15)
    assert dlv.ratio_score(np.ones(10), np.arange(10)) == 0.0


@pytest.mark.parametrize("seed, n", [(0, 100), (1, 500), (2, 2000),
                                     (4, 3000)])
def test_dlv_1d_cuts_match_reference(seed, n):
    """1-D DLV, beta = 24 sigma^2/n^2 (Theorem 2's bar): equal cuts, gids
    and bounds, and the theorem holds on the port."""
    rng = np.random.default_rng(seed)
    vals = np.sort([rng.normal(size=n), rng.exponential(size=n),
                    np.concatenate([rng.normal(-5, 0.1, n // 2),
                                    rng.normal(5, 3.0, n - n // 2)]),
                    np.round(rng.normal(size=n), 1)][seed % 4])
    beta = 24 * np.var(vals) / n ** 2
    np.testing.assert_array_equal(dlv.dlv_1d(vals, beta, device="cpu"),
                                  ref_dlv.dlv_1d(vals, beta))
    gid, bounds = dlv.dlv_1d_partition(vals, beta, device="cpu")
    want_gid, want_bounds = ref_dlv.dlv_1d_partition(vals, beta)
    np.testing.assert_array_equal(gid, want_gid)
    np.testing.assert_array_equal(bounds, want_bounds)
    assert dlv.ratio_score(vals, gid) <= 24 / n + 1e-9
    assert int(gid.max()) + 1 <= 0.75 * n + 0.5
    assert len(dlv.dlv_1d(np.zeros(0), 1.0, device="cpu")) == 0


def test_theorem1_construction_on_the_port():
    """KD-tree's ratio score explodes on the construction; 1-D DLV's is 0."""
    omega, n = 1.0, 400
    eps = 3 * omega / n
    S = np.sort(np.concatenate([[-omega, omega], np.full(n, omega + eps)]))
    beta = 24 * np.var(S) / len(S) ** 2
    gid, _ = dlv.dlv_1d_partition(S, beta, device="cpu")
    assert dlv.ratio_score(S, gid) == pytest.approx(0.0, abs=1e-12)
    kd = kdtree.kdtree_partition(S[:, None], tau=2, omega=omega)
    assert dlv.ratio_score(S, kd.gid) > 1.0


def test_dlv_beats_kdtree_on_the_port():
    """Fig. 7: DLV's ratio score beats KD-tree's at equal #groups (the
    reference's case at 20,000 rows, the DLV build on the CPU)."""
    X = np.random.default_rng(2).normal(size=(20_000, 1))
    res = dlv.dlv(X, d_f=100, device="cpu")
    kd = kdtree.kdtree_partition(X, tau=max(2, 20_000 // res.num_groups))
    assert dlv.ratio_score(X[:, 0], res.gid) < \
        dlv.ratio_score(X[:, 0], kd.gid)
