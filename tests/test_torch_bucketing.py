"""The out-of-core bucketing backend (Appendix D.2) of the port against the
JAX reference, on the CPU.

``streaming_stats`` and ``_bucket_edges`` are host numpy in both packages
and must agree exactly, a constant attribute and a point mass included;
``dlv_bucketed`` (each bucket's DLV on ``device="cpu"``: the kernels'
plain versions) must give the reference's partition exactly, through an
array, a memmap and the forced memmap spill alike.
"""
import os
import tempfile
import warnings

import numpy as np
import pytest

from repro.core import bucketing as ref_bucketing
from repro.core import relation as ref_relation
from repro_torch.core import bucketing, partitioner, relation

TREE_FIELDS = ("attr", "bound_off", "bounds", "children")


@pytest.fixture(scope="module")
def X():
    rng = np.random.default_rng(0)
    return np.concatenate([rng.normal(0, 1, (6000, 3)),
                           rng.normal(6, 2, (6000, 3))]) \
        * np.array([1.0, 4.0, 0.3])


def _point_mass():
    rng = np.random.default_rng(0)
    X = np.concatenate([np.full((6000, 2), 3.25),
                        rng.normal(10, 1, (2000, 2))])
    rng.shuffle(X)
    return X


def _constant():
    X = np.ones((4000, 2))
    X[:, 1] = np.random.default_rng(0).normal(size=4000) * 1e-12
    return X


def _same_partition(got, want):
    np.testing.assert_array_equal(got.gid, want.gid)
    np.testing.assert_array_equal(got.order, want.order)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(got.tree, f),
                                      getattr(want.tree, f))
    assert got.tree.root == want.tree.root
    for f in ("reps", "boxes_lo", "boxes_hi"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("chunk", [700, 1100, 20_000])
def test_streaming_stats_match_reference(X, chunk):
    got = bucketing.streaming_stats(bucketing.ArraySource(X), chunk)
    want = ref_bucketing.streaming_stats(ref_bucketing.ArraySource(X), chunk)
    assert got.count == want.count == len(X)
    for f in ("mean", "var", "lo", "hi"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_allclose(got.var, X.var(0), rtol=1e-10)


@pytest.mark.parametrize("case, r", [("blobs", 1000), ("blobs", 3000),
                                     ("blobs", 10**9), ("point mass", 1000),
                                     ("constant", 500)])
def test_bucket_edges_match_reference(X, case, r):
    data = {"blobs": X, "point mass": _point_mass(),
            "constant": _constant()}[case]
    st = bucketing.streaming_stats(bucketing.ArraySource(data), 1000)
    attr = 0 if case == "constant" else int(np.argmax(st.var))
    got = bucketing._bucket_edges(bucketing.ArraySource(data), attr,
                                  st.lo[attr], st.hi[attr], r, 1000)
    want = ref_bucketing._bucket_edges(ref_bucketing.ArraySource(data),
                                       attr, st.lo[attr], st.hi[attr], r,
                                       1000)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    edges, counts = got
    assert np.all(np.diff(edges) > 0) and counts.sum() == len(data)


@pytest.mark.parametrize("memory_rows, chunk_rows", [(3000, 1000),
                                                     (5000, None),
                                                     (12_000, 4000)])
def test_dlv_bucketed_matches_reference(X, memory_rows, chunk_rows):
    kw = dict(d_f=40, memory_rows=memory_rows, chunk_rows=chunk_rows)
    got = bucketing.dlv_bucketed(bucketing.ArraySource(X), device="cpu",
                                 **kw)
    want = ref_bucketing.dlv_bucketed(ref_bucketing.ArraySource(X), **kw)
    _same_partition(got, want)
    rng = np.random.default_rng(1)
    T = X[rng.choice(len(X), 500, replace=False)]
    np.testing.assert_array_equal(got.get_group_batch(T),
                                  np.fromiter((got.get_group(t) for t in T),
                                              np.int64, len(T)))


def test_bucketing_backend_draws_one_rng_in_bucket_order(X):
    """One rng through every bucket's DLV: a seeded rng gives the
    reference's partition, and the rng ends in the reference's state."""
    kw = dict(backend="bucketing", d_f=40, memory_rows=2500,
              chunk_rows=1500)
    r_port, r_ref = np.random.default_rng(5), np.random.default_rng(5)
    got = partitioner.fit(X, rng=r_port, device="cpu", **kw)
    from repro.core import partitioner as ref_partitioner
    want = ref_partitioner.fit(X, rng=r_ref, **kw)
    assert got.tree.bound_off[1] >= 3          # several buckets
    _same_partition(got, want)
    assert r_port.random() == r_ref.random()


def test_memmap_array_and_forced_spill_are_identical(tmp_path, X):
    """ArraySource, MemmapSource and the memmap spill scratch
    (``spill_rows=0``) give one partition, the reference's."""
    path = str(tmp_path / "parity.npy")
    np.save(path, X)
    kw = dict(d_f=40, memory_rows=3000, chunk_rows=1000)
    want = ref_bucketing.dlv_bucketed(ref_bucketing.ArraySource(X), **kw)
    spill_dir = tmp_path / "spill"
    spill_dir.mkdir()
    for src, extra in ((bucketing.ArraySource(X), {}),
                       (bucketing.MemmapSource(path, X.shape), {}),
                       (bucketing.ArraySource(X),
                        dict(spill_rows=0, spill_dir=str(spill_dir)))):
        _same_partition(bucketing.dlv_bucketed(src, device="cpu", **extra,
                                               **kw), want)
    assert list(spill_dir.iterdir()) == []     # the scratch was removed


def test_spill_scratch_is_removed_when_the_build_fails(tmp_path, X):
    """A source whose rows change between passes fails the spill pass;
    the memmap scratch is removed all the same.  (One bucket: a stats
    pass and one counting pass come before the spill pass.)"""

    class Shrinking(bucketing.ArraySource):
        scans = 0

        def chunks(self, chunk_rows):
            self.scans += 1
            stop = len(self.X) - (100 if self.scans > 2 else 0)
            yield from bucketing.ArraySource(self.X[:stop]).chunks(
                chunk_rows)

    with pytest.raises(RuntimeError, match="source changed"):
        bucketing.dlv_bucketed(Shrinking(X), d_f=40, memory_rows=len(X),
                               chunk_rows=1000, spill_rows=0,
                               spill_dir=str(tmp_path), device="cpu")
    assert list(tmp_path.iterdir()) == []


def test_bucket_spill_memmap_round_trip(tmp_path):
    counts = np.array([3, 0, 2])
    spill = bucketing.BucketSpill(counts, 2, budget_rows=1,
                                  spill_dir=str(tmp_path))
    assert spill.spilled and len(os.listdir(tmp_path)) == 1
    chunk = np.arange(10.0).reshape(5, 2)
    spill.add(chunk, np.array([2, 0, 0, 2, 0]), row_base=100)
    vals, rows = spill.bucket(0)
    np.testing.assert_array_equal(rows, [101, 102, 104])
    np.testing.assert_array_equal(vals, chunk[[1, 2, 4]])
    np.testing.assert_array_equal(spill.bucket(2)[1], [100, 103])
    assert len(spill.bucket(1)[0]) == 0
    spill.close()
    assert os.listdir(tmp_path) == [] and not spill.spilled
    assert not bucketing.BucketSpill(counts, 2, budget_rows=10).spilled


@pytest.mark.parametrize("case", ["point mass", "constant"])
def test_oversized_bucket_warns_as_the_reference(case):
    data = _point_mass() if case == "point mass" else np.ones((4000, 2))
    r = 1000 if case == "point mass" else 500
    kw = dict(d_f=40, memory_rows=r, chunk_rows=1000)
    with pytest.warns(UserWarning, match="oversized|memory_rows"):
        got = bucketing.dlv_bucketed(bucketing.ArraySource(data),
                                     device="cpu", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref_bucketing.dlv_bucketed(ref_bucketing.ArraySource(data),
                                          **kw)
    _same_partition(got, want)
    assert got.counts.sum() == len(data) and got.gid.min() >= 0


def test_memmap_source_checks_and_raw_file(tmp_path, X):
    path = str(tmp_path / "f32.npy")
    np.save(path, X.astype(np.float32))
    assert bucketing.MemmapSource(path, X.shape,
                                  dtype=np.float32).X.dtype == np.float32
    with pytest.raises(ValueError, match="dtype"):
        bucketing.MemmapSource(path, X.shape, dtype=np.float64)
    with pytest.raises(ValueError, match="shape"):
        bucketing.MemmapSource(path, (len(X), 99))
    raw = str(tmp_path / "raw.bin")
    X.tofile(raw)
    src = bucketing.MemmapSource.from_raw(raw, X.shape)
    assert (src.num_rows, src.num_cols) == X.shape
    np.testing.assert_array_equal(np.concatenate(list(src.chunks(1000))), X)


def test_build_is_constant_pass_count(X):
    """O(1) full streaming passes whatever the bucket count, as counted by
    both packages' ``CountingSource`` on the same build."""
    def passes(pkg_rel, pkg_b, memory_rows, **kw):
        src = pkg_rel.CountingSource(pkg_b.ArraySource(X))
        res = pkg_b.dlv_bucketed(src, d_f=40, memory_rows=memory_rows,
                                 chunk_rows=1000, **kw)
        return src.passes, int(res.tree.bound_off[1]) + 1

    for mem in (8000, 1000):
        got = passes(relation, bucketing, mem, device="cpu")
        assert got == passes(ref_relation, ref_bucketing, mem)
    (p_few, nb_few), (p_many, nb_many) = \
        passes(relation, bucketing, 8000, device="cpu"), \
        passes(relation, bucketing, 1000, device="cpu")
    assert nb_many > nb_few >= 2 and p_many <= 10 and p_many < nb_many


def test_bucket_resident_rows_count_as_the_reference(X):
    peaks = []
    for rel_mod, b_mod, kw in ((relation, bucketing, {"device": "cpu"}),
                               (ref_relation, ref_bucketing, {})):
        rel_mod.reset_peak_resident()
        b_mod.dlv_bucketed(b_mod.ArraySource(X), d_f=40, memory_rows=3000,
                           chunk_rows=1000, **kw)
        peaks.append(rel_mod.peak_resident_rows())
    assert peaks[0] == peaks[1] <= 3000


def test_spill_default_dir_is_the_temp_dir(X, monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    bucketing.dlv_bucketed(bucketing.ArraySource(X), d_f=40,
                           memory_rows=3000, chunk_rows=1000, spill_rows=0,
                           device="cpu")
    assert list(tmp_path.iterdir()) == []
