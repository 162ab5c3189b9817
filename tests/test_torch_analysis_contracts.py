"""The port's traced contracts (``repro_torch.analysis.contracts``) on the
CPU.

The tree as it stands: the CLI's host grid (a world of one rank in
process and a gloo world of two spawned over loopback) exits 0 against
the port's baseline, and its report holds the declared counts -- two
dense passes a pivot in the pq step, none in the update, one or two in
the refresh, one ``rep.cpu()`` a pivot in ``solve_lp_dist`` and one read a
pivot in the device LP, the pq step's bytes within budget.  Each contract
fires on a violation planted in a test double, at the file:line where it
was planted: a collective in the update step, a third dense pass, a stray
``.item()`` and a boolean-mask index in ``_solve``'s loop, a float64 op on float32 inputs, bytes
over budget (in a spawned world of two: one rank moves no bytes).  The
trace itself: host reads with their sites, collectives with their
groups, pivots from the loops' trace points.
"""
import inspect
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.analysis import contracts as C
from repro_torch.analysis import lint
from repro_torch.core import distributed as D
from repro_torch.runtime import tracepoints

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = "tests/test_torch_analysis_contracts.py"


def _line_of(fn, text):
    """The line of this file where ``fn``'s source holds ``text``."""
    src, first = inspect.getsourcelines(fn)
    return first + next(i for i, ln in enumerate(src) if text in ln)


@pytest.fixture(scope="module")
def host_report(tmp_path_factory):
    """The CLI on the host grid, once: (exit code, report)."""
    from repro_torch.analysis.__main__ import main
    out = tmp_path_factory.mktemp("analysis") / "analysis.json"
    rc = main(["--grid", "host", "--root", ROOT, "--baseline",
               os.path.join(ROOT, "src/repro_torch/analysis/baseline.json"),
               "--out", str(out)])
    return rc, json.loads(out.read_text())


@pytest.fixture
def world():
    with C.world1("cpu", "gloo") as ctx:
        yield ctx


def _by_name(rep):
    return {r["hot_path"]: r for r in rep["contracts"]["hot_paths"]}


# ------------------------------------------------------ the tree as it is


def test_host_grid_is_green(host_report):
    rc, rep = host_report
    assert rc == 0 and rep["exit_code"] == 0 and rep["grid"] == "host"
    assert rep["contracts"]["violations"] == []
    assert rep["baseline"]["new"] == []
    names = set(_by_name(rep))
    for want in ("distributed.pq_step@w1", "distributed.pq_step@w2",
                 "distributed.update_step@w2",
                 "distributed.refresh_step@w2",
                 "distributed.solve_lp_dist@w2",
                 "distributed.solve_lp_dist@w2_budget",
                 "distributed.pq_step@w2/rank1"):
        assert want in names
    assert any(n.startswith("lp_kernel.solve@") for n in names)
    assert any(n.startswith("lp_batch.plain@") for n in names)


@pytest.mark.parametrize("world_", ["w1", "w2", "w2/rank1"])
def test_pq_step_declared_counts(host_report, world_):
    rec = _by_name(host_report[1])["distributed.pq_step@" + world_]
    assert int(rec["dense_passes"]) == C.PQ_PASSES == 2
    assert set(rec["dense_passes_by_function"]) == {
        "pricing_plain", "BoundPQStep.__call__"}
    assert rec["host_reads"] == 0
    assert rec["budget_used_frac"] <= 1.0
    if world_ == "w1":
        assert rec["collective_bytes"]["total"] == 0.0
    else:
        # four collectives a pivot: MAX, histogram SUM, gather, tail SUM
        assert rec["collective_counts"] == {"all-reduce": 6,
                                            "all-gather": 2}
        assert rec["collective_bytes"]["total"] > 0


def test_update_and_refresh_declared_counts(host_report):
    recs = _by_name(host_report[1])
    for w in ("w1", "w2"):
        upd = recs[f"distributed.update_step@{w}"]
        assert upd["collectives"] == 0 and upd["dense_passes"] == 0
        ref = recs[f"distributed.refresh_step@{w}"]
        assert ref["dense_passes"] in (1, 2)
        assert ref["collective_counts"] == {"all-reduce": 1}


def test_pivot_loops_read_once_a_pivot(host_report):
    recs = _by_name(host_report[1])
    twin = next(r for n, r in recs.items() if n.startswith("lp_kernel."))
    assert twin["pivots"] > 5 and twin["host_reads_per_pivot"] == 1.0
    assert twin["pivots"] <= twin["max_iters"]
    assert twin["status"] == twin["solve_lp_status"] == 0
    assert abs(twin["obj"] - twin["solve_lp_obj"]) <= 1e-9 * (
        1 + abs(twin["obj"]))
    for name in ("distributed.solve_lp_dist@w1",
                 "distributed.solve_lp_dist@w2"):
        r = recs[name]
        reads = r["declared_reads"]
        assert reads["solve_lp_dist:cpu"] in (r["pivots"] - 1, r["pivots"])
        assert "_any_rank:cpu" not in reads
    r = recs["distributed.solve_lp_dist@w2_budget"]
    assert r["declared_reads"]["_any_rank:cpu"] == r["pivots"]


# ------------------------------------------------------ seeded violations


def _collective_update(step):
    def double(d, state, alpha, flip, theta, q, leave, up):
        dist.all_reduce(d)                      # planted: a collective
        return step(d, state, alpha, flip, theta, q, leave, up)
    return double


def test_seeded_collective_in_the_update_step(world):
    double = _collective_update(D.make_update_step(world.mesh))
    res = C.check_update_step(world, 4, 256, step=double)
    line = _line_of(_collective_update, "planted: a collective")
    irc1 = [v for v in res.violations if v.rule == "IRC001"]
    assert irc1 and all(v.message.startswith(f"{HERE}:{line}:")
                        for v in irc1)


class ThirdPass(D.BoundPQStep):
    def __call__(self, d_loc, state_loc, rho, s, budget):
        out = super().__call__(d_loc, state_loc, rho, s, budget)
        self.A.T @ torch.ones_like(self.A[:, 0])   # planted: a third pass
        return out


class F64Step(D.BoundPQStep):
    def __call__(self, d_loc, state_loc, rho, s, budget):
        d_loc.double()                             # planted: a float64 op
        return super().__call__(d_loc, state_loc, rho, s, budget)


def test_seeded_third_dense_pass(world):
    res = C.check_pq_step(world, 4, 256, bind=lambda st, A, l, u:
                          ThirdPass(st, A, l, u))
    line = _line_of(ThirdPass.__call__, "planted: a third pass")
    irc2 = [v.message for v in res.violations if v.rule == "IRC002"]
    assert any(m.startswith(f"{HERE}:{line}:") for m in irc2), irc2
    assert any(m.startswith("3 dense passes") for m in irc2), irc2


def test_seeded_float64_op_on_float32_inputs(world):
    res = C.check_pq_step(world, 4, 256, bind=lambda st, A, l, u:
                          F64Step(st, A, l, u))
    line = _line_of(F64Step.__call__, "planted: a float64 op")
    irc5 = [v.message for v in res.violations if v.rule == "IRC005"]
    assert irc5 and all(m.startswith(f"{HERE}:{line}:") for m in irc5)
    # the declared introductions alone make no violation
    assert C.check_pq_step(world, 4, 256).violations == []


class StrayRead:
    """The BFRT Selector with a stray host read a pivot."""

    def __init__(self, N, device):
        from repro_torch.kernels.bfrt import Selector
        self.inner = Selector(N, device)

    def __call__(self, ratio, cost, budget, rng=None):
        cost.sum().item()                          # planted: a stray read
        return self.inner(ratio, cost, budget, rng=rng)


def test_seeded_stray_item_in_the_device_lp_loop():
    from repro_torch.core import lp_kernel
    res = C.check_lp_twin("cpu", C.package_lp(64, 4), max_iters=100,
                          select=StrayRead)
    assert lp_kernel.Selector is not StrayRead          # restored
    line = _line_of(StrayRead.__call__, "planted: a stray read")
    irc3 = [v.message for v in res.violations if v.rule == "IRC003"]
    assert len(irc3) == res.record["pivots"] > 0
    assert all(m.startswith(f"{HERE}:{line}: host read item") for m in irc3)
    assert C.check_lp_twin("cpu", C.package_lp(64, 4),
                           max_iters=100).violations == []


class StrayMask:
    """The BFRT Selector with a boolean-mask index a pivot: its nonzero
    syncs inside the op, below the dispatch mode."""

    def __init__(self, N, device):
        from repro_torch.kernels.bfrt import Selector
        self.inner = Selector(N, device)

    def __call__(self, ratio, cost, budget, rng=None):
        cost[cost > 0]                             # planted: a mask index
        return self.inner(ratio, cost, budget, rng=rng)


def test_seeded_mask_index_in_the_device_lp_loop():
    res = C.check_lp_twin("cpu", C.package_lp(64, 4), max_iters=100,
                          select=StrayMask)
    line = _line_of(StrayMask.__call__, "planted: a mask index")
    irc3 = [v.message for v in res.violations if v.rule == "IRC003"]
    assert len(irc3) == res.record["pivots"] > 0
    assert all(m.startswith(f"{HERE}:{line}: host read aten.index.Tensor "
                            "(boolean mask)") for m in irc3), irc3


def _mask_read(x, m):
    x[m]


def _mask_put_tensor(x, m):
    x[m] = torch.ones(int(m.sum()), dtype=x.dtype)


def _mask_put_scalar(x, m):
    x[m] = 0.0


def _mask_put_accumulate(x, m):
    x.index_put_((m,), torch.tensor(1.0, dtype=x.dtype), accumulate=True)


def _int_index(x, m):
    x[torch.tensor([0, 2])]


@pytest.mark.parametrize("fn, reads", [
    (_mask_read, 1), (_mask_put_tensor, 1), (_mask_put_accumulate, 1),
    (_mask_put_scalar, 0), (_int_index, 0)])
def test_trace_sees_a_boolean_mask_index(fn, reads):
    """A mask index reads the mask's count on the host (an index, or an
    index_put of a tensor); a one-element host value runs as a
    masked_fill, and an integer index reads nothing."""
    x = torch.arange(6, dtype=torch.float64)
    with C.OpTrace("cpu") as tr:
        m = x > 2
        fn(x, m)
    masked = [r for r in tr.reads if r.kind.endswith("(boolean mask)")]
    assert len(masked) == reads
    assert all(r.site.file == HERE and r.site.func == fn.__name__
               for r in masked)


class LoudStep(D.BoundPQStep):
    def __call__(self, d_loc, state_loc, rho, s, budget):
        dist.all_reduce(torch.zeros(1 << 16, dtype=torch.float64))  # planted
        return super().__call__(d_loc, state_loc, rho, s, budget)


def _loud_pq(ctx):
    return [C.check_pq_step(ctx, 4, 256, bind=lambda st, A, l, u:
                            LoudStep(st, A, l, u))]


def test_seeded_bytes_over_budget():
    """In a spawned world of two (the ranks import this module)."""
    ranks = C.spawn_world(2, _loud_pq)
    line = _line_of(LoudStep.__call__, "# planted")
    for (res,) in ranks:
        irc4 = [v.message for v in res.violations if v.rule == "IRC004"]
        assert len(irc4) == 1 and irc4[0].startswith(f"{HERE}:{line}:")
        assert res.record["budget_used_frac"] > 1.0


# ------------------------------------------------------------- the trace


def test_trace_records_reads_collectives_and_pivots(world):
    A = torch.arange(12, dtype=torch.float64).reshape(3, 4)
    with C.OpTrace("cpu", watch={"A": A}) as tr:
        tracepoints.pivot("loop")
        x = A.sum()
        host = x.cpu()                       # one read ...
        float(host)                          # ... and none on its result
        tracepoints.pivot("loop")
        y = A @ torch.ones(4, dtype=torch.float64)
        dist.all_reduce(y)
        A[:, torch.tensor([1])].tolist()
        bool(y[0] > 0)
    assert tr.pivots == {"loop": 2}
    assert [(r.kind, r.pivot) for r in tr.reads] == [
        ("cpu", 1), ("tolist", 2), ("__bool__", 2)]
    assert all(r.site.file == HERE for r in tr.reads)
    assert [(c.kind, c.out_bytes, c.group, c.pivot)
            for c, _ in tr.collectives] == [("all-reduce", 24, 1, 2)]
    # A read whole twice (the sum and the mat-vec), a gathered column once
    assert sum(tr.elems["A"].values()) == 12 + 12 + 3
    assert tracepoints._listener is None


def test_trace_sees_the_declared_sites():
    assert {s for s, _, _, _, _ in C.DECLARED_READS} == {
        "core/lp_kernel.py", "core/distributed.py"}
    for suffix, func, text, _, _ in C.DECLARED_READS:
        src = (C.PKG / suffix).read_text()
        assert text in src, (suffix, text)
    hot = {(s, q) for s, q, _ in lint.HOT_LOOPS}
    assert ("core/lp_kernel.py", "_solve") in hot
    assert ("core/distributed.py", "BoundPQStep.__call__") in hot


def test_grids():
    assert C.run_contracts("none") == ([], [], 0.0)
    with pytest.raises(ValueError, match="production mesh"):
        C.run_contracts("pod")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            C.run_contracts("card")


def test_tracepoint_is_a_no_op_without_a_listener():
    assert tracepoints._listener is None
    tracepoints.pivot("x")
    seen = []
    prev = tracepoints.set_listener(seen.append)
    try:
        tracepoints.pivot("x")
    finally:
        tracepoints.set_listener(prev)
    assert seen == ["x"] and tracepoints._listener is None


def test_any_rank_agrees_on_an_int_flag():
    """``_any_rank``'s flag is an int32 (no float64 for a bool)."""
    src = inspect.getsource(D._any_rank)
    assert "torch.int32" in src and "float64" not in src
    assert np.isfinite(D.big_sentinel(torch.float32).item())
