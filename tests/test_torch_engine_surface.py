"""The reference's API surface in the port.

Each call written against ``repro.core`` that the port cannot serve yet
raises ``NotImplementedError`` naming its ROADMAP queue-1 item, instead
of a bare ``TypeError``, ``AttributeError`` or "unknown backend".  A case
goes away when its item lands, and cases of the landed surface take its
place: the engine's ``cache=`` and ``session``, the device descent
(``get_group_batch(T, jit=True)``), with a loaded hierarchy that appends
and registers with a cache, the heap-built DLV, and ``mesh=`` (a
``DeviceMesh``; here a gloo world of one rank): each mesh-sharded pass
equal to ``mesh=None`` and the reference's, anything else a
``TypeError``.
"""
import numpy as np
import pytest

import torch_dist_worker as W
from repro.core import bucketing as ref_bucketing
from repro.core import partitioner as ref_partitioner
from repro.core.hierarchy import Hierarchy as RefHierarchy
from repro_torch.core import bucketing, dlv, partitioner
from repro_torch.core.engine import PackageQueryEngine
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.qcache import QCache


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    with W.world1(tmp_path_factory.mktemp("world1") / "store"):
        yield


def _table(n=2_000):
    rng = np.random.default_rng(0)
    return {"a": rng.normal(size=n), "b": rng.uniform(0, 5, n)}


@pytest.mark.parametrize("kwarg, value, item", [
    ("mesh", object(), "item 6"),
])
def test_unported_engine_knobs_name_their_item(kwarg, value, item):
    """Item 6 has landed: a ``mesh=`` that is not a ``DeviceMesh`` is a
    ``TypeError`` that no longer points at the ROADMAP."""
    with pytest.raises(TypeError, match="DeviceMesh") as err:
        PackageQueryEngine(_table(), ["a", "b"], device="cpu",
                           **{kwarg: value})
    assert item not in str(err.value)


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


def _flat(out):
    """A call's result as a list of arrays, to compare two of them."""
    if isinstance(out, Hierarchy) or isinstance(out, RefHierarchy):
        return [a for ly in out.layers[1:] for a in _flat(ly.part)]
    if hasattr(out, "gid"):
        return [out.gid, out.order, out.offsets, out.reps, out.boxes_lo,
                out.boxes_hi]
    if hasattr(out, "var"):
        return [np.asarray(out.count), out.mean, out.var, out.lo, out.hi]
    return list(out)


@pytest.mark.parametrize("call", ["fit bucketing", "fit dlv", "hierarchy",
                                  "group_stats", "streaming_stats"])
def test_mesh_sharded_passes_name_item_6(call, world1):
    """The reference's ``mesh=`` (its sharded stats passes, item 6) on a
    world-1 mesh: the same answer as ``mesh=None`` and as the
    reference's own mesh path."""
    import jax
    X = np.random.default_rng(1).normal(size=(500, 2))
    table = _table()
    ids = (np.arange(500), np.array([0, 250, 500]))

    def calls(part, hier, bk, mesh, **dev):
        rng = np.random.default_rng(0)
        return {
            "fit bucketing": lambda: part.fit(
                X, backend="bucketing", d_f=10, mesh=mesh,
                chunk_rows=128, **dev),
            "fit dlv": lambda: part.fit(X, backend="dlv", d_f=10,
                                        mesh=mesh, chunk_rows=128, **dev),
            "hierarchy": lambda: hier(table, ["a", "b"], d_f=20, alpha=150,
                                      mesh=mesh, chunk_rows=700, rng=rng,
                                      **dev),
            "group_stats": lambda: part.group_stats(
                X, *ids, mesh=mesh, chunk_rows=100),
            "streaming_stats": lambda: bk.streaming_stats(
                bk.ArraySource(X), 100, mesh=mesh)}[call]()

    got = _flat(calls(partitioner, Hierarchy, bucketing, W.mesh(),
                      device="cpu"))
    plain = _flat(calls(partitioner, Hierarchy, bucketing, None,
                        device="cpu"))
    ref = _flat(calls(ref_partitioner, RefHierarchy, ref_bucketing,
                      jax.make_mesh((1, 1), W.NAMES)))
    assert len(got) == len(plain) == len(ref) > 0
    for g, p, r in zip(got, plain, ref):
        np.testing.assert_allclose(g, p, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=1e-12)
    with pytest.raises(TypeError, match="DeviceMesh"):
        calls(partitioner, Hierarchy, bucketing, object(), device="cpu")


def test_heap_build_through_dlv_and_fit(world1):
    """``dlv(method="heap")`` and ``fit(..., method="heap")`` reach the
    heap build (ported) and give one partition; with a mesh (item 6) and
    ``chunk_rows`` its group stats run sharded, to the same partition."""
    X = np.random.default_rng(1).normal(size=(500, 2))
    a = dlv.dlv(X, d_f=10, method="heap", device="cpu")
    b = partitioner.fit(X, backend="dlv", d_f=10, method="heap",
                        device="cpu")
    assert a.num_groups == b.num_groups >= 40
    for f in ("order", "offsets", "gid"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(a.tree.bounds, b.tree.bounds)
    c = dlv.dlv_heap(X, 10, mesh=W.mesh(), chunk_rows=128, device="cpu")
    for f in ("order", "offsets", "gid"):
        np.testing.assert_array_equal(getattr(c, f), getattr(a, f))
    np.testing.assert_allclose(c.reps, a.reps, rtol=1e-12, atol=1e-12)


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


def test_loaded_hierarchy_refuses_a_streamed_table(tmp_path):
    """``from_arrays`` stacks the layer-0 columns it is given: a streamed
    relation raises ``TypeError`` rather than being loaded whole."""
    from repro_torch.core.relation import MemmapRelation
    table = _table(200)
    npy = tmp_path / "t.npy"
    np.save(npy, np.stack([table["a"], table["b"]], axis=1))
    rel = MemmapRelation.from_npy(str(npy), ["a", "b"], chunk_rows=64)
    assert not rel.in_memory
    with pytest.raises(TypeError, match="in-memory table"):
        Hierarchy.from_arrays(rel, ["a", "b"], [], d_f=20, alpha=150,
                              device="cpu")
