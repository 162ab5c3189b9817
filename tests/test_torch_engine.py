"""The port's whole slice against the JAX reference, on the CPU.

The DLV build (``device="cpu"``: the kernels' plain versions) must give
the reference's partitions exactly; the online solve must give the
reference's package.  A reference hierarchy loaded through
``Hierarchy.from_arrays`` isolates the solve from the build.
"""
import numpy as np
import pytest

from repro.core import paql as ref_paql
from repro.core.engine import PackageQueryEngine as RefEngine
from repro.core.hardness import Q2_TPCH as REF_Q2
from repro.core.hardness import column_stats as ref_stats
from repro.core.hardness import instantiate as ref_instantiate
from repro.core.lp_kernel import solve_lp_kernel as ref_solve_lp_kernel
from repro.data.synth_tables import make_table as ref_make_table
from repro_torch.core import paql
from repro_torch.core.engine import PackageQueryEngine
from repro_torch.core.hardness import Q2_TPCH, column_stats, instantiate
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.lp_kernel import solve_lp_kernel
from repro_torch.data.synth_tables import make_table

TPCH_ATTRS = ["price", "quantity", "discount", "tax"]


def _products(n=20_000):
    """The ``examples/quickstart.py`` relation, at a smaller size."""
    rng = np.random.default_rng(0)
    return {"value": rng.lognormal(3.0, 0.6, n),
            "weight": rng.uniform(0.2, 9.0, n),
            "volume": rng.uniform(0.1, 4.0, n)}


def _products_query(mod):
    return mod.PackageQuery(
        "value", True, (mod.Constraint(None, 10, 30),
                        mod.Constraint("weight", hi=60.0),
                        mod.Constraint("volume", lo=18.0, hi=22.0)))


CASES = {
    # quickstart shape: continuous attributes, two partition layers
    "products": dict(table=_products, attrs=["value", "weight", "volume"],
                     d_f=25, alpha=150, query=_products_query),
    # TPC-H stand-in: integer quantity (ties) and Q2_TPCH at hardness 3
    "tpch": dict(table=lambda: make_table("tpch", 30_000, seed=0),
                 attrs=TPCH_ATTRS, d_f=100, alpha=500,
                 query=lambda mod: None),
}


def _query(case, table, port: bool):
    q = CASES[case]["query"](paql if port else ref_paql)
    if q is not None:
        return q
    if port:
        return instantiate(Q2_TPCH, column_stats(table, TPCH_ATTRS), 3)
    return ref_instantiate(REF_Q2, ref_stats(table, TPCH_ATTRS), 3)


@pytest.fixture(scope="module", params=sorted(CASES))
def built(request):
    """(case, table, reference engine, port engine), both partitioned."""
    cfg = CASES[request.param]
    table = cfg["table"]()
    kw = dict(d_f=cfg["d_f"], alpha=cfg["alpha"], seed=0)
    ref = RefEngine(table, cfg["attrs"], **kw).partition()
    port = PackageQueryEngine(table, cfg["attrs"], device="cpu",
                              **kw).partition()
    return request.param, table, ref, port


def _export(hier):
    """A reference hierarchy as the plain arrays of ``from_arrays``."""
    out = []
    for ly in hier.layers[1:]:
        p, t = ly.part, ly.part.tree
        out.append(dict(gid=p.gid, order=p.order, offsets=p.offsets,
                        reps=p.reps, lo=p.boxes_lo, hi=p.boxes_hi,
                        attr=t.attr, bound_off=t.bound_off, bounds=t.bounds,
                        children=t.children, root=t.root, eps=ly.eps))
    return out


def test_dlv_build_matches_reference(built):
    """Identical layers: gids, order, offsets and split trees exactly;
    reps and boxes to 1e-12 (exact sums in the same order, but the
    reference's boxes and reps come from the same reduceat pass)."""
    _, _, ref, port = built
    assert [ly.size for ly in port.hierarchy.layers] == \
        [ly.size for ly in ref.hierarchy.layers]
    assert port.hierarchy.L >= 1
    for lr, lp in zip(ref.hierarchy.layers[1:], port.hierarchy.layers[1:]):
        pr, pp = lr.part, lp.part
        np.testing.assert_array_equal(pp.gid, pr.gid)
        np.testing.assert_array_equal(pp.order, pr.order)
        np.testing.assert_array_equal(pp.offsets, pr.offsets)
        for f in ("attr", "bound_off", "bounds", "children"):
            np.testing.assert_array_equal(getattr(pp.tree, f),
                                          getattr(pr.tree, f))
        assert pp.tree.root == pr.tree.root
        for f in ("reps", "boxes_lo", "boxes_hi"):
            np.testing.assert_allclose(getattr(pp, f), getattr(pr, f),
                                       rtol=1e-12, atol=0)
        assert lp.eps == lr.eps
    assert port.hierarchy.fingerprint == ref.hierarchy.fingerprint


def test_solve_matches_reference(built):
    """Default host LP path: the same package (idx, mult) and objective
    to 1e-9 relative."""
    case, table, ref, port = built
    want = ref.solve(_query(case, table, port=False))
    got = port.solve(_query(case, table, port=True))
    assert want.feasible and got.feasible
    np.testing.assert_array_equal(got.idx, want.idx)
    np.testing.assert_array_equal(got.mult, want.mult)
    assert got.obj == pytest.approx(want.obj, rel=1e-9)
    assert got.report.status == want.report.status
    assert got.ps_stats.layer_sizes == want.ps_stats.layer_sizes


def test_device_lp_path_matches_reference(built):
    """Layer LPs through ``solve_lp_kernel`` in both packages (the port on
    the CPU with the kernels' plain versions -- the engine hands the bare
    function its own device -- the reference in interpret mode):
    objective within 1e-6 relative and a valid package."""
    case, table, ref, port = built
    q_ref = _query(case, table, port=False)
    q = _query(case, table, port=True)
    want = ref.solve(q_ref, lp_solver=ref_solve_lp_kernel)
    got = port.solve(q, lp_solver=solve_lp_kernel)
    assert want.feasible and got.feasible
    assert got.obj == pytest.approx(want.obj, rel=1e-6)
    assert q.check_package(table, got.idx, got.mult)
    assert q_ref.check_package(table, got.idx, got.mult)


def test_from_arrays_solve_matches_reference(built):
    """A reference hierarchy loaded into the port solves to the
    reference's package."""
    case, table, ref, port = built
    h = ref.hierarchy
    loaded = Hierarchy.from_arrays(table, h.attrs, _export(h), d_f=h.d_f,
                                   alpha=h.alpha, device="cpu",
                                   eps0=h.layers[0].eps)
    assert loaded.fingerprint == h.fingerprint
    for l in range(1, h.L + 1):
        T = h.layers[l - 1].X[:50]
        np.testing.assert_array_equal(loaded.get_group_batch(l, T),
                                      h.get_group_batch(l, T))
    eng = PackageQueryEngine(table, h.attrs, d_f=h.d_f, alpha=h.alpha,
                             seed=0, device="cpu")
    eng.hierarchy = loaded
    got = eng.solve(_query(case, table, port=True))
    want = RefEngine(table, h.attrs, d_f=h.d_f, alpha=h.alpha, seed=0)
    want.hierarchy = h
    want = want.solve(_query(case, table, port=False))
    np.testing.assert_array_equal(got.idx, want.idx)
    np.testing.assert_array_equal(got.mult, want.mult)
    assert got.obj == pytest.approx(want.obj, rel=1e-9)


def test_numpy_copies_match_reference():
    """The port's own copies of the table generator and the hardness
    machinery give the reference's table and bounds exactly."""
    got, want = make_table("tpch", 5000, seed=3), ref_make_table("tpch",
                                                                  5000,
                                                                  seed=3)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for h in (1, 3, 5):
        q = instantiate(Q2_TPCH, column_stats(got, TPCH_ATTRS), h)
        qr = ref_instantiate(REF_Q2, ref_stats(want, TPCH_ATTRS), h)
        assert [(c.attr, c.lo, c.hi) for c in q.constraints] == \
            [(c.attr, c.lo, c.hi) for c in qr.constraints]


def test_guarded_solve_contains_errors():
    """The guard contract: a query over a missing column returns an
    error status instead of raising, like the reference."""
    table = _products(2000)
    bad = paql.PackageQuery("value", True, (paql.Constraint("nope",
                                                            hi=1.0),))
    eng = PackageQueryEngine(table, ["value", "weight", "volume"], d_f=10,
                             alpha=100, device="cpu")
    res = eng.solve(bad)
    assert not res.feasible and res.report.status == "error"
    with pytest.raises(KeyError):
        eng.solve(bad, guarded=False)
