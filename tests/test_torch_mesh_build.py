"""The mesh-sharded build passes of the port against ``mesh=None`` and
the reference's mesh paths.

``group_stats(mesh=, chunk_rows=)`` (each rank's rows through the
segment-stats kernel's plain version, a SUM over the mesh's leading
dim), ``streaming_stats(mesh=)`` and the bucket counts of
``dlv_bucketed(mesh=)``, the DLV builds, ``Hierarchy`` and
``PackageQueryEngine(mesh=, chunk_rows=)``, and a whole solve through
``solve_lp(mesh=)``: on gloo worlds of 1 (in this process), 2 (meshes
(1, 2) and (2,)) and 4 (mesh (2, 2)) ranks (``torch_dist_worker``), the
reference on JAX host meshes of the same shapes.
"""
import functools

import jax
import numpy as np
import pytest

import torch_dist_worker as W
from repro.core import paql as ref_paql
from repro.core.bucketing import (ArraySource as RefArraySource,
                                  dlv_bucketed as ref_dlv_bucketed,
                                  streaming_stats as ref_streaming_stats)
from repro.core.engine import PackageQueryEngine as RefEngine
from repro.core.lp import solve_lp as ref_solve_lp
from repro.core.partitioner import fit as ref_fit
from repro.core.partitioner import group_stats as ref_group_stats
from repro_torch.core import dlv, paql, partitioner
from repro_torch.core.bucketing import (ArraySource, dlv_bucketed,
                                        streaming_stats)
from repro_torch.core.engine import PackageQueryEngine
from repro_torch.core.hierarchy import Hierarchy

# (world, mesh shape): the build passes shard over the leading dim, so
# (1, 2) leaves them whole at world 2 and (2,) splits them
MESHES = ((1, (1, 1)), (2, (1, 2)), (2, (2,)), (4, (2, 2)))
IDS = [f"world{w}-{'x'.join(map(str, s))}" for w, s in MESHES]
CHUNK = 2048


def _names(shape):
    return W.NAMES[:len(shape)]


@functools.lru_cache(maxsize=1)
def _X():
    """``tests/test_partitioner.py``'s relation."""
    rng = np.random.default_rng(7)
    return np.concatenate([
        rng.normal(0, 1, (9000, 3)),
        rng.normal(7, 2, (9000, 3)),
    ]) * np.array([1.0, 4.0, 0.3])


@functools.lru_cache(maxsize=1)
def _Xb():
    """``tests/test_bucketing.py``'s relation."""
    rng = np.random.default_rng(0)
    return np.concatenate([
        rng.normal(0, 1, (8000, 3)),
        rng.normal(6, 2, (8000, 3)),
    ]) * np.array([1.0, 4.0, 0.3])


def _Y():
    """Large means, small spreads: an unshifted variance cancels."""
    X = _Xb()
    return np.stack([1e9 + X[:, 0], 2e9 + X[:, 1]], axis=1)


def _products(n=20_000):
    """The ``examples/quickstart.py`` relation, at a smaller size."""
    rng = np.random.default_rng(0)
    return {"value": rng.lognormal(3.0, 0.6, n),
            "weight": rng.uniform(0.2, 9.0, n),
            "volume": rng.uniform(0.1, 4.0, n)}


ATTRS = ["value", "weight", "volume"]
ENGINE = dict(d_f=25, alpha=150, seed=0, chunk_rows=4096)
BUCKETED = dict(d_f=40, memory_rows=3000, chunk_rows=1000)


def _query(mod):
    return mod.PackageQuery(
        "value", True, (mod.Constraint(None, 10, 30),
                        mod.Constraint("weight", hi=60.0),
                        mod.Constraint("volume", lo=18.0, hi=22.0)))


@functools.lru_cache(maxsize=1)
def _ref_part():
    return ref_fit(_X(), backend="dlv", d_f=60)


def _cases(world):
    part = _ref_part()
    cases = []
    for w, shape in MESHES:
        if w != world:
            continue
        at = dict(mesh=(shape, _names(shape)))
        tag = "x".join(map(str, shape))
        cases += [
            (f"group_stats {tag}", "group_stats", dict(
                at, X=_X(), order=part.order, offsets=part.offsets,
                chunk_rows=CHUNK)),
            (f"streaming_stats {tag}", "streaming_stats", dict(
                at, Y=_Y(), chunk_rows=1100)),
            (f"dlv_bucketed {tag}", "dlv_bucketed", dict(
                at, X=_Xb(), **BUCKETED)),
            (f"fit dlv {tag}", "fit", dict(at, X=_X(), backend="dlv",
                                           d_f=60, chunk_rows=CHUNK)),
            (f"heap {tag}", "fit", dict(at, X=_X()[::6], d_f=30,
                                        chunk_rows=700, heap=True)),
            (f"hierarchy {tag}", "hierarchy", dict(
                at, table=_products(), attrs=ATTRS, d_f=25, alpha=150,
                chunk_rows=4096)),
            (f"engine {tag}", "engine", dict(
                at, table=_products(), attrs=ATTRS,
                query=_query(paql) if shape == (1, 2) else None,
                **ENGINE))]
    return tuple(cases)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    with W.world1(tmp_path_factory.mktemp("world1") / "store"):
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory, world1):
    """{world: [rank 0's results, ...]}, every case of the world."""
    out = {1: [W.run(_cases(1))]}
    for world in (2, 4):
        out[world] = W.spawn(world, _cases(world),
                             tmp_path_factory.mktemp(f"world{world}"))
    return out


def _got(runs, world, shape, kind):
    return runs[world][0][f"{kind} {'x'.join(map(str, shape))}"]


def _ref_mesh(shape):
    return jax.make_mesh(shape, _names(shape))


def _same_partition(got, want, reps_rtol=None):
    for k in ("gid", "order", "offsets"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("reps", "lo", "hi"):
        if reps_rtol is None:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=reps_rtol,
                                       atol=reps_rtol, err_msg=k)


def _as_dict(p):
    return {"gid": p.gid, "order": p.order, "offsets": p.offsets,
            "reps": p.reps, "lo": p.boxes_lo, "hi": p.boxes_hi}


@pytest.mark.parametrize("world, shape", MESHES, ids=IDS)
def test_group_stats_matches_reference_and_dense(runs, world, shape):
    """``tests/test_partitioner.py::test_group_stats_sharded_on_mesh``:
    the sharded chunked sums against the reference's mesh path on the
    same mesh shape and against the dense pass, rtol 1e-8."""
    got = _got(runs, world, shape, "group_stats")
    part = _ref_part()
    dense = ref_group_stats(_X(), part.order, part.offsets)
    ref = ref_group_stats(_X(), part.order, part.offsets,
                          mesh=_ref_mesh(shape), chunk_rows=CHUNK)
    for k, d, r in zip(("reps", "lo", "hi"), dense, ref):
        np.testing.assert_allclose(got[k], d, rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(got[k], r, rtol=1e-8, atol=1e-8)


def test_group_stats_wider_than_the_kernel_on_a_mesh(world1):
    """Eleven columns: the sharded sums go through segment stats in
    blocks of at most ``MAX_K`` (8) columns; equal to the dense pass."""
    from repro_torch.kernels.segstats import MAX_K
    X = np.random.default_rng(5).normal(size=(3000, MAX_K + 3)) * 10 + 4
    order = np.random.default_rng(6).permutation(3000)
    offsets = np.array([0, 7, 700, 701, 2300, 3000])
    got = partitioner.group_stats(X, order, offsets, mesh=W.mesh(),
                                  chunk_rows=512)
    for g, d in zip(got, ref_group_stats(X, order, offsets)):
        np.testing.assert_allclose(g, d, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("world, shape", MESHES, ids=IDS)
def test_streaming_stats_match_host_and_reference(runs, world, shape):
    """``tests/test_bucketing.py::test_mesh_stats_and_build_parity``'s
    data (means 1e9 and 2e9): the shifted sums keep the variance."""
    got = _got(runs, world, shape, "streaming_stats")
    host = streaming_stats(ArraySource(_Y()), 1100)
    ref = ref_streaming_stats(RefArraySource(_Y()), 1100,
                              mesh=_ref_mesh(shape))
    for want in (host, ref):
        assert got["count"] == want.count == len(_Y())
        np.testing.assert_allclose(got["mean"], want.mean, rtol=1e-12)
        np.testing.assert_allclose(got["var"], want.var, rtol=1e-6)
        assert int(np.argmax(got["var"])) == int(np.argmax(want.var))
        np.testing.assert_array_equal(got["lo"], want.lo)
        np.testing.assert_array_equal(got["hi"], want.hi)


@pytest.mark.parametrize("world, shape", MESHES, ids=IDS)
def test_dlv_bucketed_is_gid_identical(runs, world, shape):
    """The sharded stats and counting passes give the same buckets: the
    build equals ``mesh=None``'s and the reference's mesh build."""
    got = _got(runs, world, shape, "dlv_bucketed")
    plain = dlv_bucketed(ArraySource(_Xb()), device="cpu", **BUCKETED)
    _same_partition(got, _as_dict(plain))
    ref = ref_dlv_bucketed(RefArraySource(_Xb()), mesh=_ref_mesh(shape),
                           **BUCKETED)
    np.testing.assert_array_equal(got["gid"], ref.gid)
    np.testing.assert_array_equal(got["offsets"], ref.offsets)
    np.testing.assert_allclose(got["reps"], ref.reps, rtol=1e-12)


@pytest.mark.parametrize("world, shape", MESHES, ids=IDS)
def test_dlv_builds_with_a_mesh_equal_mesh_none(runs, world, shape):
    """``fit(backend="dlv")`` and ``dlv_heap`` with ``chunk_rows`` and a
    mesh: the partition of ``mesh=None``, reps to 1e-12 (the shards' sums
    add up in another order), and the reference's gids."""
    got = _got(runs, world, shape, "fit dlv")
    plain = partitioner.fit(_X(), backend="dlv", d_f=60, chunk_rows=CHUNK,
                            device="cpu")
    _same_partition(got, _as_dict(plain), reps_rtol=1e-12)
    np.testing.assert_array_equal(got["gid"], _ref_part().gid)
    heap = _got(runs, world, shape, "heap")
    plain = dlv.dlv_heap(_X()[::6], 30, chunk_rows=700, device="cpu")
    _same_partition(heap, _as_dict(plain), reps_rtol=1e-12)


@pytest.mark.parametrize("world, shape", MESHES, ids=IDS)
def test_hierarchy_and_engine_partitions_equal_mesh_none(runs, world,
                                                         shape):
    """``Hierarchy(mesh=, chunk_rows=)`` and ``PackageQueryEngine(mesh=,
    chunk_rows=).partition()``: every layer's partition equal to
    ``mesh=None``'s (reps to 1e-12)."""
    h = Hierarchy(_products(), ATTRS, d_f=25, alpha=150, chunk_rows=4096,
                  rng=np.random.default_rng(0), device="cpu")
    want = [_as_dict(ly.part) for ly in h.layers[1:]]
    eng = PackageQueryEngine(_products(), ATTRS, device="cpu",
                             **ENGINE).partition()
    want_eng = [_as_dict(ly.part) for ly in eng.hierarchy.layers[1:]]
    for kind, ref in (("hierarchy", want), ("engine", want_eng)):
        got = _got(runs, world, shape, kind)["layers"]
        assert len(got) == len(ref) >= 2
        for g, r in zip(got, ref):
            _same_partition(g, r, reps_rtol=1e-12)


def test_engine_solve_through_the_mesh_matches_reference(runs):
    """World 2, mesh (1, 2): the engine partitioned on the mesh, every
    layer LP through ``solve_lp(mesh=, device="cpu")``, gives the
    reference engine's package and objective through its ``solve_lp(
    mesh=)`` on the same mesh shape."""
    got = _got(runs, 2, (1, 2), "engine")
    mesh = _ref_mesh((1, 2))
    ref = RefEngine(_products(), ATTRS, mesh=mesh, **ENGINE).partition()
    want = ref.solve(_query(ref_paql), lp_solver=functools.partial(
        ref_solve_lp, mesh=mesh))
    assert got["feasible"] and want.feasible
    assert got["report"] == "ok"
    np.testing.assert_array_equal(got["idx"], want.idx)
    np.testing.assert_array_equal(got["mult"], want.mult)
    assert got["obj"] == pytest.approx(want.obj, rel=1e-9)
    # the whole pipeline held on both ranks
    other = runs[2][1]["engine 1x2"]
    np.testing.assert_array_equal(other["idx"], got["idx"])
    assert other["obj"] == got["obj"]


@pytest.mark.parametrize("world", (2, 4))
def test_every_rank_builds_the_same(runs, world):
    for name, _, _ in _cases(world):
        first = runs[world][0][name]
        for other in runs[world][1:]:
            for k, v in first.items():
                if k == "layers":
                    for a, b in zip(v, other[name][k]):
                        for f in a:
                            assert a[f].tobytes() == b[f].tobytes()
                elif isinstance(v, np.ndarray):
                    assert v.tobytes() == other[name][k].tobytes(), k
                else:
                    assert other[name][k] == v, k
