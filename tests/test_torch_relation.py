"""The streamed relations of the port against the JAX reference, on the CPU.

``MemmapRelation``, ``SourceRelation`` and ``CountingSource`` must give
the reference's chunks and gathers exactly; transient read faults retry
as the reference's do (same results, same retry counts, the same error
once the tries run out); and ``peak_resident_rows`` must count what the
reference counts on the same calls, so that the reference's resident
bounds carry over.
"""
import numpy as np
import pytest

from repro.core import bucketing as ref_bucketing
from repro.core import relation as ref_relation
from repro_torch.core import bucketing, relation

COLS = ["v", "w", "ok"]
PKGS = {"ref": (ref_relation, ref_bucketing), "port": (relation, bucketing)}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    n = 5000
    return np.stack([rng.normal(10, 2, n), rng.uniform(0.5, 2.0, n),
                     (rng.random(n) < 0.5).astype(np.float64)], axis=1)


@pytest.fixture(scope="module")
def npy(tmp_path_factory, data):
    path = str(tmp_path_factory.mktemp("rel") / "rel.npy")
    np.save(path, data)
    return path


@pytest.fixture(autouse=True)
def no_backoff_sleep():
    """Retries without their sleeps, the policy restored afterwards."""
    saved = [mod.configure_retries() for mod in (ref_relation, relation)]
    for mod in (ref_relation, relation):
        mod.configure_retries(base_s=0.0, max_s=0.0)
    yield
    for mod, pol in zip((ref_relation, relation), saved):
        mod.configure_retries(**pol)


def _relations(kind, npy, data, rel_mod, src_mod):
    if kind == "memmap":
        return rel_mod.MemmapRelation.from_npy(npy, COLS, chunk_rows=700)
    if kind == "raw":
        return rel_mod.MemmapRelation.from_raw(
            npy, COLS, rows=len(data), offset=128, chunk_rows=700)
    if kind == "source":
        return rel_mod.SourceRelation(src_mod.ArraySource(data), COLS,
                                      chunk_rows=700)
    if kind == "array":
        return rel_mod.ArrayRelation({c: data[:, j]
                                      for j, c in enumerate(COLS)})
    src = rel_mod.CountingSource(src_mod.MemmapSource(npy))
    return rel_mod.as_relation(src, columns=COLS)


KINDS = ["memmap", "raw", "source", "array", "counting"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("names, step", [(None, None), (("w", "v"), 700),
                                         (("ok",), 1234)])
def test_chunks_match_reference(kind, names, step, npy, data):
    got = list(_relations(kind, npy, data, *PKGS["port"]).chunks(names,
                                                                 step))
    want = list(_relations(kind, npy, data, *PKGS["ref"]).chunks(names,
                                                                 step))
    assert [len(c) for c in got] == [len(c) for c in want]
    np.testing.assert_array_equal(np.concatenate(got),
                                  np.concatenate(want))


@pytest.mark.parametrize("kind", KINDS)
def test_gathers_match_reference(kind, npy, data):
    port = _relations(kind, npy, data, *PKGS["port"])
    ref = _relations(kind, npy, data, *PKGS["ref"])
    rng = np.random.default_rng(1)
    idx = rng.choice(len(data), 300, replace=True)    # unsorted, duplicates
    mask = data[:, 2] > 0
    for sel in (idx, np.array([4999, 0, 700, 699, 701, 0]), mask,
                np.zeros(0, np.int64)):
        got, want = port.gather_rows(sel, ("v", "ok")), \
            ref.gather_rows(sel, ("v", "ok"))
        for c in ("v", "ok"):
            np.testing.assert_array_equal(got[c], want[c])
    np.testing.assert_array_equal(port.gather_matrix(idx, ("w", "v")),
                                  ref.gather_matrix(idx, ("w", "v")))
    np.testing.assert_array_equal(port["w"][idx], ref["w"][idx])
    np.testing.assert_array_equal(relation.gather_column(port, "v", mask),
                                  ref_relation.gather_column(ref, "v", mask))
    hi = port.reduce_columns(("v", "w"), lambda c: c.max(axis=0),
                             np.maximum)
    np.testing.assert_array_equal(hi, ref.reduce_columns(
        ("v", "w"), lambda c: c.max(axis=0), np.maximum))
    for bad in (np.array([3, -1]), np.array([len(data)]), mask[:10]):
        with pytest.raises(IndexError):
            port.gather_rows(bad, ("v",))


def test_lazy_column_gathers_but_never_materialises(npy, data):
    rel = relation.MemmapRelation.from_npy(npy, COLS)
    col = rel["v"]
    assert isinstance(col, relation.LazyColumn) and len(col) == len(data)
    np.testing.assert_array_equal(col[np.array([5, 2, 5])],
                                  data[[5, 2, 5], 0])
    np.testing.assert_array_equal(col[10:20], data[10:20, 0])
    assert col[7] == data[7, 0]
    with pytest.raises(RuntimeError, match="refusing to materialise"):
        np.asarray(col)
    with pytest.raises(KeyError):
        rel["nope"]


def test_chunk_sources_and_coercions(npy, data):
    rel = relation.MemmapRelation.from_npy(npy, COLS)
    full = rel.chunk_source()
    assert isinstance(full, bucketing.MemmapSource) and full.X is rel.X
    part = rel.chunk_source(["w"], 1000)
    assert part.num_rows == len(data) and part.num_cols == 1
    np.testing.assert_array_equal(np.concatenate(list(part.chunks(999))),
                                  data[:, 1:2])
    assert relation.as_relation(rel) is rel
    assert isinstance(relation.as_relation({"a": np.ones(3)}),
                      relation.ArrayRelation)
    assert isinstance(relation.as_relation(bucketing.ArraySource(data),
                                           columns=COLS),
                      relation.MemmapRelation)
    with pytest.raises(ValueError):
        relation.as_relation(relation.CountingSource(
            bucketing.ArraySource(data)))
    with pytest.raises(ValueError):
        relation.SourceRelation(bucketing.ArraySource(data), ["a"])
    with pytest.raises(TypeError):
        relation.as_relation(object())
    src = relation.CountingSource(bucketing.ArraySource(data))
    for _ in range(2):
        for _ in src.chunks(700):
            pass
    assert (src.passes, src.rows_read) == (2, 2 * len(data))


class _FlakyArray:
    """An (n, k) array whose first ``fails`` reads raise ``OSError``."""

    def __init__(self, X, fails):
        self.X, self.fails = X, fails
        self.ndim, self.shape = X.ndim, X.shape

    def __getitem__(self, key):
        if self.fails > 0:
            self.fails -= 1
            raise OSError("transient read fault")
        return self.X[key]


class _FlakySource:
    """A ChunkSource whose first ``fails`` scans raise mid-stream, after
    ``after`` blocks."""

    def __init__(self, X, fails, after, base):
        self.X, self.fails, self.after, self.base = X, fails, after, base

    @property
    def num_rows(self):
        return len(self.X)

    @property
    def num_cols(self):
        return self.X.shape[1]

    def chunks(self, chunk_rows):
        for i, block in enumerate(self.base(self.X).chunks(chunk_rows)):
            if self.fails > 0 and i == self.after:
                self.fails -= 1
                raise OSError("transient scan fault")
            yield block


@pytest.mark.parametrize("fails", [0, 1, 3, 4])
def test_retries_match_reference(fails, data):
    """A reader that fails ``fails`` times: with four tries the memmap
    chunk read, the gather and the source scan retry to the reference's
    result and retry count; the fourth failure gives up as it does."""
    idx = np.array([17, 3, 4998, 3])
    for which in ("chunk", "gather", "scan"):
        outs = {}
        for name, (rel_mod, src_mod) in PKGS.items():
            r0 = rel_mod.io_retry_count()
            if which == "scan":
                rel = rel_mod.SourceRelation(_FlakySource(
                    data, fails, 2, src_mod.ArraySource), COLS,
                    chunk_rows=700)
            else:
                rel = rel_mod.MemmapRelation(_FlakyArray(data, fails), COLS,
                                             chunk_rows=700)
            try:
                got = rel.gather_matrix(idx) if which == "gather" else \
                    np.concatenate(list(rel.chunks()))
            except OSError as e:
                got = str(e)
            outs[name] = (got, rel_mod.io_retry_count() - r0)
        (got, n_got), (want, n_want) = outs["port"], outs["ref"]
        assert n_got == n_want == min(fails, 3), which
        if fails >= 4:
            assert "giving up after 4 attempts" in got
            assert got == want
        else:
            np.testing.assert_array_equal(got, want)


def test_retry_policy_matches_reference():
    assert relation.configure_retries() == {"tries": 4, "base_s": 0.0,
                                            "max_s": 0.0, "seed": 0}
    assert relation.configure_retries(tries=0)["tries"] == 1
    calls = []

    def flaky():
        calls.append(1)
        raise OSError("always")

    with pytest.raises(OSError, match="x: giving up after 1 attempts"):
        relation._retry_io(flaky, "x")
    assert len(calls) == 1


def test_peak_resident_rows_count_as_the_reference(npy, data):
    """The same calls on both packages' relations: chunks, gathers, a lazy
    column, a dict table's gather -- the same peak after each."""
    steps = [lambda r, a: list(r.chunks(("v",), 900)),
             lambda r, a: r.gather_rows(np.arange(1234), ("w",)),
             lambda r, a: r["v"][np.arange(2000)],
             lambda r, a: a.gather_rows(np.arange(3000), ("v",)),
             lambda r, a: list(r.chunks(None, 4500))]
    peaks = {}
    for name, (rel_mod, _) in PKGS.items():
        rel = rel_mod.MemmapRelation.from_npy(npy, COLS, chunk_rows=700)
        arr = rel_mod.ArrayRelation({"v": data[:, 0]})
        rel_mod.reset_peak_resident()
        assert rel_mod.peak_resident_rows() == 0
        peaks[name] = []
        for step in steps:
            step(rel, arr)
            peaks[name].append(rel_mod.peak_resident_rows())
    assert peaks["port"] == peaks["ref"] == [900, 1234, 2000, 3000, 4500]
