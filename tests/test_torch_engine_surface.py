"""The reference's API surface in the port.

Each call written against ``repro.core`` that the port cannot serve yet
raises ``NotImplementedError`` naming its ROADMAP queue-1 item, instead
of a bare ``TypeError``, ``AttributeError`` or "unknown backend".  A case
goes away when its item lands, and cases of the landed surface take its
place: the engine's ``cache=`` and ``session`` and the device descent
(``get_group_batch(T, jit=True)``), with a loaded hierarchy that appends
and registers with a cache.
"""
import numpy as np
import pytest

from repro_torch.core import bucketing, dlv, partitioner
from repro_torch.core.engine import PackageQueryEngine
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.qcache import QCache


def _table(n=2_000):
    rng = np.random.default_rng(0)
    return {"a": rng.normal(size=n), "b": rng.uniform(0, 5, n)}


@pytest.mark.parametrize("kwarg, value, item", [
    ("mesh", object(), "item 6"),
])
def test_unported_engine_knobs_name_their_item(kwarg, value, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1, {item}"):
        PackageQueryEngine(_table(), ["a", "b"], device="cpu",
                           **{kwarg: value})


def test_engine_knobs_left_at_their_defaults_build():
    eng = PackageQueryEngine(_table(), ["a", "b"], cache=False, mesh=None,
                             layer0_backend=None, device="cpu")
    assert eng.n == 2_000
    assert eng.cache is None


def test_cache_true_builds_a_private_qcache():
    a = PackageQueryEngine(_table(), ["a", "b"], cache=True, device="cpu")
    b = PackageQueryEngine(_table(), ["a", "b"], cache=True, device="cpu")
    assert isinstance(a.cache, QCache) and isinstance(b.cache, QCache)
    assert a.cache is not b.cache
    assert PackageQueryEngine(_table(), ["a", "b"], cache=None,
                              device="cpu").cache is None


def test_shared_cache_is_kept_by_identity():
    shared = QCache()
    assert len(shared) == 0              # empty: falsy by len, kept all the same
    engines = [PackageQueryEngine(_table(), ["a", "b"], cache=shared,
                                  device="cpu") for _ in range(2)]
    assert all(e.cache is shared for e in engines)


def test_session_shares_hierarchy_and_cache_and_owns_its_rng():
    eng = PackageQueryEngine(_table(), ["a", "b"], d_f=20, alpha=150,
                             cache=True, device="cpu").partition()
    s1, s2 = eng.session(7), eng.session(7)
    for s in (s1, s2):
        assert s.hierarchy is eng.hierarchy and s.cache is eng.cache
        assert s.table is eng.table and s.device == eng.device
        assert s.rng is not eng.rng
    assert s1.rng is not s2.rng
    assert s1.rng.integers(0, 1 << 30, 4).tolist() == \
        np.random.default_rng(7).integers(0, 1 << 30, 4).tolist()
    assert s2.rng.integers(0, 1 << 30, 4).tolist() == \
        np.random.default_rng(7).integers(0, 1 << 30, 4).tolist()


@pytest.mark.parametrize("call", ["fit bucketing", "fit dlv", "hierarchy",
                                  "group_stats", "streaming_stats"])
def test_mesh_sharded_passes_name_item_6(call):
    """The reference's ``mesh=`` (its sharded stats passes) is item 6."""
    X = np.random.default_rng(1).normal(size=(500, 2))
    mesh = object()
    calls = {
        "fit bucketing": lambda: partitioner.fit(
            X, backend="bucketing", d_f=10, mesh=mesh, device="cpu"),
        "fit dlv": lambda: partitioner.fit(X, backend="dlv", d_f=10,
                                           mesh=mesh, device="cpu"),
        "hierarchy": lambda: Hierarchy(_table(), ["a", "b"], d_f=20,
                                       alpha=150, mesh=mesh, device="cpu"),
        "group_stats": lambda: partitioner.group_stats(
            X, np.arange(500), np.array([0, 250, 500]), mesh=mesh,
            chunk_rows=100),
        "streaming_stats": lambda: bucketing.streaming_stats(
            bucketing.ArraySource(X), 100, mesh=mesh)}
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue 1, item 6"):
        calls[call]()


def test_heap_build_names_item_8():
    X = np.random.default_rng(1).normal(size=(500, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 8"):
        dlv.dlv(X, d_f=10, method="heap", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 8"):
        partitioner.fit(X, backend="dlv", d_f=10, method="heap",
                        device="cpu")


@pytest.mark.parametrize("level", ["partition", "hierarchy"])
def test_device_descent_equals_the_host_descent(level):
    table = _table()
    h = Hierarchy(table, ["a", "b"], d_f=20, alpha=150,
                  rng=np.random.default_rng(0), device="cpu")
    T = np.stack([table["a"][:50], table["b"][:50]], axis=1)
    want = h.get_group_batch(1, T)
    assert want.shape == (50,)
    if level == "partition":
        got = h.layers[1].part.get_group_batch(T, jit=True, device="cpu")
    else:
        got = h.get_group_batch(1, T, jit=True)
    assert isinstance(got, np.ndarray) and got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_loaded_hierarchy_appends_and_registers_with_a_cache():
    """``from_arrays`` sets up the append state and the hooks as the
    constructor does."""
    table = _table()
    built = Hierarchy(table, ["a", "b"], d_f=20, alpha=150,
                      rng=np.random.default_rng(0), device="cpu")
    layers = []
    for ly in built.layers[1:]:
        p, t = ly.part, ly.part.tree
        layers.append(dict(gid=p.gid, order=p.order, offsets=p.offsets,
                           reps=p.reps, lo=p.boxes_lo, hi=p.boxes_hi,
                           attr=t.attr, bound_off=t.bound_off,
                           bounds=t.bounds, children=t.children,
                           root=t.root, eps=ly.eps))
    h = Hierarchy.from_arrays(table, ["a", "b"], layers, d_f=20, alpha=150,
                              device="cpu")
    cache = QCache()
    assert cache.register(h) == built.fingerprint
    heard = []
    h.add_invalidation_hook(lambda hier, touched: heard.append(touched))
    rows = {"a": table["a"][:5], "b": table["b"][:5]}
    rep = h.append(rows)
    np.testing.assert_array_equal(rep.gids, built.layers[1].part.gid[:5])
    np.testing.assert_array_equal(heard[0], np.unique(rep.gids))
    assert h.leaf_counts.sum() == 2_000 + 5
    want = built.append(rows)
    assert rep.tv_bar == want.tv_bar
    np.testing.assert_array_equal(rep.flagged, want.flagged)
