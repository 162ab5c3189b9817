"""The streamed (out-of-core) hierarchy and engine of the port against the
JAX reference, on the CPU.

A ``MemmapRelation`` is partitioned through the bucketing backend at
layer 0 (each bucket's DLV with ``device="cpu"``: the kernels' plain
versions) and solved with Progressive Shading: the port must build the
reference's layers exactly and return its package (``idx`` and ``mult``
equal, ``obj`` within 1e-9; 1e-6 through the device LP).  The memmap and
dict builds agree, the solve stays candidate-resident, and the
full-relation baselines stream behind their size guard.
"""
import numpy as np
import pytest
import torch

from repro.core import paql as ref_paql
from repro.core import relation as ref_relation
from repro.core.engine import PackageQueryEngine as RefEngine
from repro.core.hierarchy import Hierarchy as RefHierarchy
from repro.core.lp_kernel import solve_lp_kernel as ref_solve_lp_kernel
from repro_torch.core import paql, partitioner, relation
from repro_torch.core.engine import PackageQueryEngine
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.lp_kernel import solve_lp_kernel

N = 24_000
ATTRS = ["v", "w"]
ILP_KW = dict(max_nodes=100, time_limit_s=10)
KW = dict(d_f=20, alpha=1500, seed=0, memory_rows=6000, chunk_rows=3000)
TREE_FIELDS = ("attr", "bound_off", "bounds", "children")


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(7)
    return {"v": rng.normal(10, 2, N), "w": rng.uniform(0.5, 2.0, N)}


@pytest.fixture(scope="module")
def npy(tmp_path_factory, table):
    path = str(tmp_path_factory.mktemp("ooc") / "rel.npy")
    np.save(path, np.stack([table[a] for a in ATTRS], axis=1))
    return path


def _query(mod):
    return mod.PackageQuery("v", maximize=True,
                            constraints=(mod.Constraint(None, 5, 15),
                                         mod.Constraint("w", hi=20.0)))


@pytest.fixture(scope="module")
def engines(npy):
    """(reference engine, port engine) over the memmap, both partitioned;
    the resident-row peaks of each build."""
    ref = RefEngine(ref_relation.MemmapRelation.from_npy(
        npy, ATTRS, chunk_rows=4000), ATTRS, **KW)
    port = PackageQueryEngine(relation.MemmapRelation.from_npy(
        npy, ATTRS, chunk_rows=4000), ATTRS, device="cpu", **KW)
    peaks = []
    for mod, eng in ((ref_relation, ref), (relation, port)):
        mod.reset_peak_resident()
        eng.partition()
        peaks.append(mod.peak_resident_rows())
    return ref, port, peaks


def _same_layers(got, want, exact=True):
    assert [ly.size for ly in got.layers] == [ly.size for ly in want.layers]
    for lg, lw in zip(got.layers[1:], want.layers[1:]):
        pg, pw = lg.part, lw.part
        for f in ("gid", "order", "offsets"):
            np.testing.assert_array_equal(getattr(pg, f), getattr(pw, f))
        for f in TREE_FIELDS:
            np.testing.assert_array_equal(getattr(pg.tree, f),
                                          getattr(pw.tree, f))
        for f in ("reps", "boxes_lo", "boxes_hi"):
            np.testing.assert_allclose(getattr(pg, f), getattr(pw, f),
                                       rtol=0 if exact else 1e-12, atol=0)
        assert lg.eps == lw.eps


def test_streamed_hierarchy_matches_reference(engines):
    ref, port, peaks = engines
    h = port.hierarchy
    assert h.layers[0].X is None and h.layers[0].eps == 1e-9
    assert h.layers[0].size == N and h.L >= 1
    assert h.layer0_backend == ref.hierarchy.layer0_backend == "bucketing"
    _same_layers(h, ref.hierarchy)
    assert h.fingerprint == ref.hierarchy.fingerprint
    # the build's resident set: the largest bucket, as the reference counts
    assert peaks[1] == peaks[0] <= KW["memory_rows"]
    rng = np.random.default_rng(1)
    idx = np.sort(rng.choice(N, 200, replace=False))
    T = port.table.gather_matrix(idx, ATTRS)
    np.testing.assert_array_equal(h.get_group_batch(1, T),
                                  h.layers[1].part.gid[idx])


def test_memmap_and_dict_builds_are_identical(engines, table):
    """A dict table with ``layer0_backend="bucketing"`` and the same
    ``memory_rows`` / ``chunk_rows`` builds the memmap's layers."""
    _, port, _ = engines
    dict_eng = PackageQueryEngine(table, ATTRS, layer0_backend="bucketing",
                                  device="cpu", **KW).partition()
    assert dict_eng.hierarchy.layers[0].X is not None
    _same_layers(dict_eng.hierarchy, port.hierarchy)


def test_streamed_solve_matches_reference(engines):
    ref, port, _ = engines
    want = ref.solve(_query(ref_paql), ilp_kwargs=ILP_KW)
    got = port.solve(_query(paql), ilp_kwargs=ILP_KW)
    assert want.feasible and got.feasible
    np.testing.assert_array_equal(got.idx, want.idx)
    np.testing.assert_array_equal(got.mult, want.mult)
    assert got.obj == pytest.approx(want.obj, rel=1e-9)
    assert got.report.status == want.report.status
    assert got.report.fault_retries == want.report.fault_retries == 0
    assert _query(paql).check_package(port.table, got.idx, got.mult)


def test_streamed_device_lp_path_matches_reference(engines):
    """Layer LPs through ``solve_lp_kernel`` in both packages (the port's
    on the engine's device, here the CPU): objective within 1e-6."""
    ref, port, _ = engines
    want = ref.solve(_query(ref_paql), ilp_kwargs=ILP_KW,
                     lp_solver=ref_solve_lp_kernel)
    got = port.solve(_query(paql), ilp_kwargs=ILP_KW,
                     lp_solver=solve_lp_kernel)
    assert want.feasible and got.feasible
    assert got.obj == pytest.approx(want.obj, rel=1e-6)
    assert _query(paql).check_package(port.table, got.idx, got.mult)


def test_memmap_and_dict_solves_agree(engines, table):
    _, port, _ = engines
    dict_eng = PackageQueryEngine(table, ATTRS, layer0_backend="bucketing",
                                  device="cpu", **KW)
    r_mem = dict_eng.solve(_query(paql), ilp_kwargs=ILP_KW)
    r_ooc = port.solve(_query(paql), ilp_kwargs=ILP_KW)
    assert r_mem.feasible and r_ooc.feasible
    assert r_ooc.obj == pytest.approx(r_mem.obj, rel=1e-12)
    np.testing.assert_array_equal(r_mem.idx, r_ooc.idx)
    np.testing.assert_array_equal(r_mem.mult, r_ooc.mult)


def test_solve_stays_candidate_resident(engines):
    """The reference's bound: the solve gathers candidate subsets only,
    O(alpha), never the relation -- and the same peak as the reference."""
    ref, port, _ = engines
    peaks = []
    for mod, eng, q in ((relation, port, _query(paql)),
                        (ref_relation, ref, _query(ref_paql))):
        mod.reset_peak_resident()
        assert eng.solve(q, ilp_kwargs=ILP_KW).feasible
        peaks.append(mod.peak_resident_rows())
    assert peaks[0] == peaks[1]
    assert peaks[0] <= 2 * port.alpha and peaks[0] < N // 2


def test_solve_direct_streams_behind_its_guard(engines, table, monkeypatch):
    ref, port, _ = engines
    r_ooc = port.solve_direct(_query(paql), ilp_kwargs=ILP_KW)
    r_mem = PackageQueryEngine(table, ATTRS, device="cpu", **KW) \
        .solve_direct(_query(paql), ilp_kwargs=ILP_KW)
    want = ref.solve_direct(_query(ref_paql), ilp_kwargs=ILP_KW)
    assert r_ooc.feasible and r_mem.feasible
    assert r_ooc.obj == pytest.approx(r_mem.obj, rel=1e-12)
    assert r_ooc.obj == pytest.approx(want.obj, rel=1e-9)
    assert port.lp_bound(_query(paql)) == pytest.approx(
        ref.lp_bound(_query(ref_paql)), rel=1e-9)
    monkeypatch.setattr(paql, "FULL_MATRIX_BUDGET_BYTES", 1024)
    with pytest.raises(ValueError, match="engine.solve"):
        port.solve_direct(_query(paql))
    with pytest.raises(ValueError, match="engine.solve"):
        port.lp_bound(_query(paql))


def test_streamed_relation_rejects_array_only_backend(npy):
    rel = relation.MemmapRelation.from_npy(npy, ATTRS)
    with pytest.raises(TypeError, match="cannot consume a streamed"):
        Hierarchy(rel, ATTRS, d_f=20, alpha=1500, backend="kdtree",
                  device="cpu")


@pytest.mark.parametrize("backend", ["dlv", "kdtree"])
def test_in_memory_chunked_layer0_stats_match_reference(table, backend):
    """``chunk_rows`` on an in-memory table: layer 0's group stats run
    chunk by chunk (``dlv``), as the reference's do; ``kdtree`` refuses
    it as the reference does."""
    kw = dict(d_f=20, alpha=1500, chunk_rows=5000, backend=backend)
    if backend == "kdtree":
        with pytest.raises(TypeError, match="mesh/chunk_rows"):
            Hierarchy(table, ATTRS, device="cpu", **kw)
        return
    got = Hierarchy(table, ATTRS, rng=np.random.default_rng(0),
                    device="cpu", **kw)
    want = RefHierarchy(table, ATTRS, rng=np.random.default_rng(0), **kw)
    _same_layers(got, want, exact=False)
    X = np.stack([table[a] for a in ATTRS], axis=1)
    part = got.layers[1].part
    whole = partitioner.group_stats(X, part.order, part.offsets)
    for g, w in zip(whole, (part.reps, part.boxes_lo, part.boxes_hi)):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card contract is moot")


@pytest.mark.parametrize("entry", ["fit bucketing", "dlv_1d",
                                   "sketch_refine", "engine over memmap",
                                   "hierarchy over memmap"])
def test_streamed_entry_points_raise_without_cuda(entry, npy, table):
    """Every new entry point defaults to CUDA and raises without a card."""
    _no_cuda()
    from repro_torch.core import dlv
    from repro_torch.core.sketchrefine import sketch_refine
    rel = relation.MemmapRelation.from_npy(npy, ATTRS)
    calls = {
        "fit bucketing": lambda: partitioner.fit(
            rel.chunk_source(), backend="bucketing", d_f=20,
            memory_rows=6000),
        "dlv_1d": lambda: dlv.dlv_1d(np.sort(table["v"]), 1.0),
        "sketch_refine": lambda: sketch_refine(_query(paql), table, ATTRS),
        "engine over memmap": lambda: PackageQueryEngine(rel, ATTRS),
        "hierarchy over memmap": lambda: Hierarchy(rel, ATTRS, d_f=20,
                                                   alpha=1500)}
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()


# ------------------------------------------------------------- appends


def _hierarchies(source, npy, table):
    """(reference, port) hierarchies over a dict or a memmap."""
    if source == "dict":
        return (RefHierarchy(table, ATTRS, d_f=20, alpha=1500),
                Hierarchy(table, ATTRS, d_f=20, alpha=1500, device="cpu"))
    kw = dict(d_f=20, alpha=1500, memory_rows=6000, chunk_rows=3000)
    return (RefHierarchy(ref_relation.MemmapRelation.from_npy(
                npy, ATTRS, chunk_rows=4000), ATTRS, **kw),
            Hierarchy(relation.MemmapRelation.from_npy(
                npy, ATTRS, chunk_rows=4000), ATTRS, device="cpu", **kw))


def _same_report(got, want):
    np.testing.assert_array_equal(got.gids, want.gids)
    np.testing.assert_array_equal(got.flagged, want.flagged)
    assert got.tv_bar == want.tv_bar


@pytest.mark.parametrize("source", ["dict", "memmap"])
def test_append_lands_in_rebuild_groups(source, npy, table):
    """Appended copies of existing tuples land in exactly the group a full
    (deterministic) rebuild assigns them, with the reference's report and
    leaf counts; the moments' pass streams the memmap."""
    ref, port = _hierarchies(source, npy, table)
    X = np.stack([table[a] for a in ATTRS], axis=1)
    idx = np.random.default_rng(3).choice(N, 300, replace=False)
    want, got = ref.append(X[idx]), port.append(X[idx])
    _same_report(got, want)
    np.testing.assert_array_equal(got.gids, port.layers[1].part.gid[idx])
    assert port.leaf_counts.sum() == N + 300
    np.testing.assert_array_equal(port.leaf_counts, ref.leaf_counts)
    grown = port.leaf_counts - port.layers[1].part.counts
    np.testing.assert_array_equal(
        grown, np.bincount(got.gids, minlength=len(grown)))
    for key in ("cnt", "s1", "s2"):
        np.testing.assert_array_equal(port._append_state[key],
                                      ref._append_state[key])


@pytest.mark.parametrize("source", ["dict", "memmap"])
def test_append_flags_variance_crossing_leaves(source, npy, table):
    ref, port = _hierarchies(source, npy, table)
    X = np.stack([table[a] for a in ATTRS], axis=1)
    # a wide blob centred on one tuple blows up its leaf's variance
    blob = X[100] + np.random.default_rng(4).normal(0, 8.0, (4000, 2))
    want, got = ref.append(blob), port.append(blob)
    _same_report(got, want)
    assert len(got.flagged) > 0 and got.tv_bar > 0
    st = port._append_state
    nz = np.maximum(st["cnt"], 1.0)[:, None]
    var = np.maximum(st["s2"] / nz - (st["s1"] / nz) ** 2, 0.0)
    tv = st["cnt"] * var.max(axis=1)
    assert np.all(tv[got.flagged] > got.tv_bar)


def test_append_over_streamed_relation(npy):
    """The reference's streamed case: rows gathered from the memmap land
    in their own leaves."""
    kw = dict(d_f=20, alpha=1500, memory_rows=6000, chunk_rows=3000)
    rel = relation.MemmapRelation.from_npy(npy, ATTRS, chunk_rows=4000)
    hier = Hierarchy(rel, ATTRS, device="cpu", **kw)
    rows = rel.gather_matrix(np.arange(50), ATTRS)
    rep = hier.append(rows)             # moments init streams the relation
    np.testing.assert_array_equal(rep.gids, hier.layers[1].part.gid[:50])
    assert hier.leaf_counts.sum() == N + 50
    ref = RefHierarchy(ref_relation.MemmapRelation.from_npy(
        npy, ATTRS, chunk_rows=4000), ATTRS, **kw)
    _same_report(rep, ref.append(ref.relation.gather_matrix(np.arange(50),
                                                            ATTRS)))
