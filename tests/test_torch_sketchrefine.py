"""The SketchRefine baseline of the port against the JAX reference, on the
CPU.

Resident tables partition with ``kdtree`` (host numpy in both packages)
or ``dlv`` (the port's build with ``device="cpu"``: the kernels' plain
versions); a ``MemmapRelation`` partitions through ``bucketing``.  The
sketch and refine ILPs are host B&B in both.  The port must return the
reference's result: the same status, ``idx`` and ``mult``, and ``obj``
within 1e-9.
"""
import numpy as np
import pytest

from repro.core import paql as ref_paql
from repro.core import relation as ref_relation
from repro.core.engine import PackageQueryEngine as RefEngine
from repro.core.hardness import Q2_TPCH as REF_Q2
from repro.core.hardness import column_stats as ref_stats
from repro.core.hardness import instantiate as ref_instantiate
from repro.core.sketchrefine import query_attrs as ref_query_attrs
from repro.core.sketchrefine import sketch_refine as ref_sketch_refine
from repro_torch.core import paql, relation
from repro_torch.core.engine import PackageQueryEngine
from repro_torch.core.hardness import Q2_TPCH, column_stats, instantiate
from repro_torch.core.sketchrefine import query_attrs, sketch_refine
from repro_torch.data.synth_tables import make_table

ILP_KW = dict(max_nodes=100, time_limit_s=20)
TPCH_ATTRS = ["price", "quantity", "discount", "tax"]


def _vw(n=12_000):
    rng = np.random.default_rng(7)
    return {"v": rng.normal(10, 2, n), "w": rng.uniform(0.5, 2.0, n)}


def _vw_query(mod):
    return mod.PackageQuery("v", maximize=True,
                            constraints=(mod.Constraint(None, 5, 15),
                                         mod.Constraint("w", hi=20.0)))


CASES = {
    "vw": (_vw, ["v", "w"], lambda mod, t: _vw_query(mod)),
    "tpch h=3": (lambda: make_table("tpch", 20_000, seed=1), TPCH_ATTRS,
                 lambda mod, t: (
                     instantiate(Q2_TPCH, column_stats(t, TPCH_ATTRS), 3)
                     if mod is paql else
                     ref_instantiate(REF_Q2, ref_stats(t, TPCH_ATTRS), 3))),
}


def _same_result(got, want):
    assert got.status == want.status
    assert got.feasible == want.feasible
    np.testing.assert_array_equal(got.idx, want.idx)
    np.testing.assert_array_equal(got.mult, want.mult)
    assert got.obj == pytest.approx(want.obj, rel=1e-9)
    assert got.lp_obj == pytest.approx(want.lp_obj, rel=1e-9)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("backend", ["kdtree", "dlv"])
def test_resident_sketchrefine_matches_reference(case, backend):
    make, attrs, query = CASES[case]
    table = make()
    q = query(paql, table)
    got = sketch_refine(q, table, attrs, backend=backend,
                        ilp_kwargs=ILP_KW, device="cpu")
    want = ref_sketch_refine(query(ref_paql, table), table, attrs,
                             backend=backend, ilp_kwargs=ILP_KW)
    _same_result(got, want)
    if got.feasible:
        assert q.check_package(table, got.idx, got.mult)


@pytest.mark.parametrize("tau_frac", [0.001, 0.004])
def test_memmap_sketchrefine_matches_reference(tmp_path, tau_frac):
    """Streamed: the bucketing partition, refine steps gathering only the
    fixed tuples and one group's members -- through the engine."""
    table = _vw()
    path = str(tmp_path / "rel.npy")
    np.save(path, np.stack([table["v"], table["w"]], axis=1))
    kw = dict(d_f=20, alpha=1500, seed=0, memory_rows=4000, chunk_rows=1500)
    port = PackageQueryEngine(relation.MemmapRelation.from_npy(
        path, ["v", "w"]), ["v", "w"], device="cpu", **kw)
    ref = RefEngine(ref_relation.MemmapRelation.from_npy(path, ["v", "w"]),
                    ["v", "w"], **kw)
    relation.reset_peak_resident()
    got = port.solve_sketchrefine(_vw_query(paql), tau_frac=tau_frac,
                                  ilp_kwargs=ILP_KW)
    peak = relation.peak_resident_rows()
    want = ref.solve_sketchrefine(_vw_query(ref_paql), tau_frac=tau_frac,
                                  ilp_kwargs=ILP_KW)
    _same_result(got, want)
    assert got.feasible
    assert _vw_query(paql).check_package(port.table, got.idx, got.mult)
    assert peak <= kw["memory_rows"]     # buckets, then small gathers


def test_engine_sketchrefine_on_a_dict_matches_reference():
    table = _vw(6000)
    got = PackageQueryEngine(table, ["v", "w"], d_f=20, alpha=500,
                             device="cpu").solve_sketchrefine(
        _vw_query(paql), ilp_kwargs=ILP_KW)
    want = RefEngine(table, ["v", "w"], d_f=20, alpha=500) \
        .solve_sketchrefine(_vw_query(ref_paql), ilp_kwargs=ILP_KW)
    _same_result(got, want)


def test_sketch_infeasible_matches_reference():
    """A count no package of representatives can meet: the sketch fails
    and both packages say so."""
    table = _vw(3000)

    def q(mod):
        return mod.PackageQuery("v", maximize=True,
                                constraints=(mod.Constraint(None, 5, 15),
                                             mod.Constraint("w", hi=1.0)))

    got = sketch_refine(q(paql), table, ["v", "w"], ilp_kwargs=ILP_KW,
                        device="cpu")
    want = ref_sketch_refine(q(ref_paql), table, ["v", "w"],
                             ilp_kwargs=ILP_KW)
    _same_result(got, want)
    assert got.status == "sketch_infeasible"


def test_query_attrs_match_reference():
    table = make_table("tpch", 2000, seed=0)
    q = instantiate(Q2_TPCH, column_stats(table, TPCH_ATTRS), 5)
    qr = ref_instantiate(REF_Q2, ref_stats(table, TPCH_ATTRS), 5)
    assert query_attrs(q, table) == ref_query_attrs(qr, table)
