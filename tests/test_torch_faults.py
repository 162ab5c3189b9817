"""Fault injection in the port against the JAX reference, on the CPU.

``repro_torch.runtime.faults`` is the reference's injector copied: the
same sites, per-thread streams (stream 0 from ``SeedSequence(seed)``,
stream k from ``SeedSequence(seed, spawn_key=(k-1,))``) and thread-scoped
activations.  Its hooks sit where the reference's do, inside the reads
that ``_retry_io`` retries and at the top of each ``solve_lp_np`` pivot,
so the twins of ``tests/test_resilience.py``'s fault cases give the
reference's results, fire counts and retry counts, and the engine under
each of the four arms gives the reference's status, ``fault_retries``,
fire counts, package and objective.  The reference's
``test_dist_shard_fault_falls_back_to_single_host`` waits for the
distributed pivot loop (ROADMAP queue 1, item 6): until then ``SHARD``
never fires in the port.
"""
import threading

import numpy as np
import pytest

from repro.core import guard as ref_guard
from repro.core import relation as ref_relation
from repro.core.bucketing import ArraySource as RefArraySource
from repro.core.bucketing import MemmapSource as RefMemmapSource
from repro.core.engine import PackageQueryEngine as RefEngine
from repro.core.hardness import TEMPLATES as REF_TEMPLATES
from repro.core.hardness import column_stats as ref_column_stats
from repro.core.hardness import instantiate as ref_instantiate
from repro.core.lp import solve_lp_np as ref_solve_lp_np
from repro.data.synth_tables import make_table
from repro.runtime import faults as ref_faults
from repro_torch.core import guard, relation
from repro_torch.core.bucketing import ArraySource, MemmapSource
from repro_torch.core.engine import PackageQueryEngine
from repro_torch.core.hardness import TEMPLATES, column_stats, instantiate
from repro_torch.core.lp import OPTIMAL, solve_lp_np
from repro_torch.runtime import faults
from repro_torch.runtime.racecheck import run_threads

ILP_KW = dict(max_nodes=100, time_limit_s=10)
SITES = (faults.CHUNK_READ, faults.GATHER_READ, faults.BINV, faults.SHARD)


@pytest.fixture(autouse=True)
def fast_retries():
    saved = [mod.configure_retries() for mod in (ref_relation, relation)]
    for mod in (ref_relation, relation):
        mod.configure_retries(base_s=1e-4, max_s=1e-3)
    yield
    for mod, pol in zip((ref_relation, relation), saved):
        mod.configure_retries(**pol)


def _mat(n=20, k=3):
    return np.arange(float(n * k)).reshape(n, k)


def test_site_names_and_shared_state_are_the_reference_s():
    assert SITES == (ref_faults.CHUNK_READ, ref_faults.GATHER_READ,
                     ref_faults.BINV, ref_faults.SHARD)
    assert faults.SHARED_MUTABLE == ("_ACTIVE",)
    assert faults.get() is None and faults.fire_count(faults.BINV) == 0
    arr = np.ones(3)
    assert faults.perturb(faults.BINV, arr) is arr   # no injector: identity
    faults.maybe_raise(faults.CHUNK_READ)            # no injector: no-op


# ------------------------------------------------------- transient reads


@pytest.mark.parametrize("times", [1, 2, 3])
def test_chunk_read_retry_recovers(times):
    X = _mat()
    out = {}
    for name, mod, fl in (("ref", ref_relation, ref_faults),
                          ("port", relation, faults)):
        rel = mod.MemmapRelation(X, ["a", "b", "c"], chunk_rows=5)
        r0 = mod.io_retry_count()
        with fl.injected(seed=1,
                         arms={fl.CHUNK_READ: dict(times=times)}) as inj:
            got = np.vstack(list(rel.chunks()))
        np.testing.assert_array_equal(got, X)
        out[name] = (inj.fire_count(fl.CHUNK_READ),
                     mod.io_retry_count() - r0, inj.log)
    assert out["port"] == out["ref"]
    assert out["port"][:2] == (times, times)


def test_chunk_read_retry_gives_up():
    rel = relation.MemmapRelation(_mat(), ["a", "b", "c"], chunk_rows=5)
    with faults.injected(seed=1,
                         arms={faults.CHUNK_READ: dict(times=None)}) as inj:
        with pytest.raises(OSError, match="giving up after 4 attempts"):
            list(rel.chunks())
    assert inj.fire_count(faults.CHUNK_READ) == 4


def test_gather_read_retry_recovers():
    X = _mat()
    idx = np.array([7, 0, 13, 7])
    got = {}
    for name, mod, fl in (("ref", ref_relation, ref_faults),
                          ("port", relation, faults)):
        rel = mod.MemmapRelation(X, ["a", "b", "c"])
        with fl.injected(seed=2,
                         arms={fl.GATHER_READ: dict(times=1)}) as inj:
            out = rel.gather_rows(idx, ("b",))["b"]
        np.testing.assert_array_equal(out, X[idx, 1])
        got[name] = inj.fire_count(fl.GATHER_READ)
    assert got == {"ref": 1, "port": 1}


def test_memmap_source_chunk_read_retries(tmp_path):
    """``MemmapSource.chunks`` (the bucketing backend's stream) polls
    ``CHUNK_READ`` inside its retried read, as the reference's does."""
    X = _mat(23, 3)
    path = str(tmp_path / "x.npy")
    np.save(path, X)
    got = {}
    for name, src_cls, fl in (("ref", RefMemmapSource, ref_faults),
                              ("port", MemmapSource, faults)):
        with fl.injected(seed=4,
                         arms={fl.CHUNK_READ: dict(times=2)}) as inj:
            out = np.vstack(list(src_cls(path).chunks(5)))
        np.testing.assert_array_equal(out, X)
        got[name] = inj.fire_count(fl.CHUNK_READ)
    assert got == {"ref": 2, "port": 2}


def test_backoff_capped_and_deterministic(monkeypatch):
    """Delays follow min(max_s, base_s * 2^k) with seeded jitter -- the
    schedule is capped and replays identically, as the reference's."""
    relation.configure_retries(tries=4, base_s=0.1, max_s=0.15, seed=5)
    rel = relation.MemmapRelation(_mat(), ["a", "b", "c"], chunk_rows=100)

    def _delays():
        slept = []
        monkeypatch.setattr(relation.time, "sleep", slept.append)
        with faults.injected(seed=1,
                             arms={faults.CHUNK_READ: dict(times=3)}):
            list(rel.chunks())
        return slept

    d1, d2 = _delays(), _delays()
    assert d1 == d2                      # deterministic replay
    rng = np.random.default_rng(5)
    exp = [min(0.15, 0.1 * 2.0 ** k) * (0.5 + rng.random())
           for k in range(3)]
    np.testing.assert_allclose(d1, exp)
    assert max(d1) <= 0.15 * 1.5 + 1e-12  # capped


def test_flaky_source_scan_delivers_rows_exactly_once():
    X = _mat(23, 3)
    raised = {}
    for name, mod, src_mod, fl in (
            ("ref", ref_relation, RefArraySource, ref_faults),
            ("port", relation, ArraySource, faults)):
        src = fl.FlakySource(src_mod(X), fail_chunks=(1,), fail_times=2)
        rel = mod.SourceRelation(src, ["a", "b", "c"], chunk_rows=4)
        np.testing.assert_array_equal(np.vstack(list(rel.chunks())), X)
        raised[name] = (src.raised, dict(src.attempts))
    assert raised["port"] == raised["ref"] == (2, {1: 2})


def test_source_scan_chunk_read_fault_restarts_exactly_once():
    """``SourceRelation.chunks`` polls ``CHUNK_READ`` once a block, inside
    the restartable loop: a fault restarts the scan and skips the rows
    already delivered."""
    X = _mat(23, 3)
    fired = {}
    for name, mod, src_mod, fl in (
            ("ref", ref_relation, RefArraySource, ref_faults),
            ("port", relation, ArraySource, faults)):
        rel = mod.SourceRelation(src_mod(X), ["a", "b", "c"], chunk_rows=4)
        with fl.injected(seed=6, arms={fl.CHUNK_READ: dict(
                times=2, after=3)}) as inj:
            np.testing.assert_array_equal(np.vstack(list(rel.chunks())), X)
        fired[name] = (inj.fire_count(fl.CHUNK_READ), inj.log)
    assert fired["port"] == fired["ref"]
    assert fired["port"][0] == 2


def test_flaky_source_scan_gives_up():
    src = faults.FlakySource(ArraySource(_mat()), fail_chunks=(0,),
                             fail_times=99)
    rel = relation.SourceRelation(src, ["a", "b", "c"], chunk_rows=4)
    with pytest.raises(OSError, match="source scan: giving up"):
        list(rel.chunks())


# -------------------------------------------------- numerical health / LP


def _random_lp(seed, n=160, m=6):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    ub = rng.integers(1, 4, size=n).astype(float)
    x0 = rng.uniform(0, 1, n) * ub
    act = A @ x0
    width = np.abs(rng.normal(size=m)) * 2
    bl = act - width * rng.uniform(0, 1, m)
    bu = act + width * rng.uniform(0, 1, m)
    return c, A, bl, bu, ub


@pytest.mark.parametrize("arm", [dict(times=2, after=1, scale=1e-2),
                                 dict(times=3, after=1, scale=1e-3)])
def test_binv_perturbation_detected_and_recovered(arm):
    """An injected Binv corruption trips the drift monitor, forces a
    refactorization, and the solve still reaches the clean optimum --
    with the reference's fire count, and its objective under the same
    faults."""
    c, A, bl, bu, ub = _random_lp(7, n=240, m=14)
    clean = solve_lp_np(c, A, bl, bu, ub)
    assert clean.status == OPTIMAL and clean.iters > 20
    out = {}
    for name, solve, fl, gd in (("ref", ref_solve_lp_np, ref_faults,
                                 ref_guard),
                                ("port", solve_lp_np, faults, guard)):
        mon = gd.NumericalMonitor(drift_check_every=4)
        with fl.injected(seed=0, arms={fl.BINV: arm}) as inj:
            res = solve(c, A, bl, bu, ub, monitor=mon)
        out[name] = (res, mon, inj.fire_count(fl.BINV))
    res, mon, fired = out["port"]
    ref_res, ref_mon, ref_fired = out["ref"]
    assert fired == ref_fired >= 1
    assert res.status == OPTIMAL == ref_res.status
    assert mon.drift_refactors >= 1
    assert mon.drift_refactors == ref_mon.drift_refactors
    assert abs(res.obj - clean.obj) <= 1e-6 * (1 + abs(clean.obj))
    assert abs(res.obj - ref_res.obj) <= 1e-6 * (1 + abs(ref_res.obj))


# --------------------------------------------------------- engine contract


def _memmap_engine(side, n=2000, seed=0):
    t = make_table("tpch", n, seed=seed)
    attrs = ["price", "quantity", "discount", "tax"]
    X = np.stack([np.asarray(t[a], np.float64) for a in attrs], axis=1)
    if side == "ref":
        rel = ref_relation.MemmapRelation(X, attrs,
                                          chunk_rows=max(n // 7, 16))
        eng = RefEngine(rel, attrs, d_f=8, alpha=300, seed=seed)
        eng._stats = ref_column_stats(t, attrs)
    else:
        rel = relation.MemmapRelation(X, attrs, chunk_rows=max(n // 7, 16))
        eng = PackageQueryEngine(rel, attrs, d_f=8, alpha=300, seed=seed,
                                 device="cpu")
        eng._stats = column_stats(t, attrs)
    return eng


def _query(side, eng, h=2.0, template="Q2_TPCH"):
    if side == "ref":
        return ref_instantiate(REF_TEMPLATES[template], eng._stats, h)
    return instantiate(TEMPLATES[template], eng._stats, h)


ARMS = [(faults.CHUNK_READ, dict(times=2)),
        (faults.GATHER_READ, dict(times=None, prob=0.3)),
        (faults.BINV, dict(times=3, after=1, scale=1e-3)),
        (faults.SHARD, dict(times=1))]


def _solve_under(side, site, arm, seed=3):
    eng = _memmap_engine(side)
    eng.partition()
    q = _query(side, eng)
    fl = ref_faults if side == "ref" else faults
    with fl.injected(seed=seed, arms={site: arm}) as inj:
        res = eng.solve(q, ilp_kwargs=ILP_KW)
    return eng, q, res, {s: inj.fire_count(s) for s in SITES}


@pytest.mark.parametrize("site,arm", ARMS, ids=[s for s, _ in ARMS])
def test_engine_never_raises_under_faults(site, arm):
    """The guard contract: under injected faults every engine.solve
    returns a report with a defined status -- and the port's equals the
    reference's under the same seed and arm: status, ``fault_retries``,
    fire counts, package and objective."""
    eng, q, res, fired = _solve_under("port", site, arm)
    assert res.report is not None
    assert res.report.status in guard.STATUSES
    if res.feasible:
        assert q.check_package(eng.table, res.idx, res.mult)
    _, _, ref, ref_fired = _solve_under("ref", site, arm)
    assert res.report.status == ref.report.status
    assert res.report.fault_retries == ref.report.fault_retries
    assert fired == ref_fired
    assert fired[faults.SHARD] == 0        # polled nowhere until item 6
    assert res.feasible == ref.feasible
    if ref.feasible:
        np.testing.assert_array_equal(res.idx, ref.idx)
        np.testing.assert_allclose(res.mult, ref.mult, rtol=1e-6)
        assert abs(res.obj - ref.obj) <= 1e-6 * max(1.0, abs(ref.obj))


@pytest.mark.parametrize("site", [faults.CHUNK_READ, faults.GATHER_READ])
def test_read_faults_are_transparent(site):
    """A retried read gives the rows a clean read gives: with the build
    and the solve under read faults, the layers and the package equal
    the clean run's."""
    eng = _memmap_engine("port")
    eng.partition()
    q = _query("port", eng)
    clean = eng.solve(q, ilp_kwargs=ILP_KW)
    eng2 = _memmap_engine("port")
    r0 = relation.io_retry_count()
    with faults.injected(seed=3, arms={site: dict(ARMS)[site]}) as inj:
        eng2.partition()
        res = eng2.solve(q, ilp_kwargs=ILP_KW)
    assert inj.fire_count(site) >= 1
    assert relation.io_retry_count() - r0 == inj.fire_count(site)
    assert len(eng.hierarchy.layers) == len(eng2.hierarchy.layers)
    for a, b in zip(eng.hierarchy.layers[1:], eng2.hierarchy.layers[1:]):
        np.testing.assert_array_equal(a.part.gid, b.part.gid)
    assert res.feasible == clean.feasible
    np.testing.assert_array_equal(res.idx, clean.idx)
    np.testing.assert_array_equal(res.mult, clean.mult)


def test_engine_reports_fault_retries():
    eng = _memmap_engine("port")
    eng.partition()
    q = _query("port", eng)
    with faults.injected(seed=3,
                         arms={faults.GATHER_READ: dict(times=3)}) as inj:
        res = eng.solve(q, ilp_kwargs=ILP_KW)
    assert inj.fire_count(faults.GATHER_READ) == 3
    assert res.report.fault_retries >= 3
    assert res.report.status in (guard.OK, guard.DEGRADED)


# ------------------------------------------------------- fault injector


def test_faults_single_thread_stream_matches_legacy_seed():
    """Stream 0 is bit-identical to a single ``default_rng(seed)``, and to
    the reference injector's stream 0."""
    for seed in (0, 5, 123):
        inj = faults.FaultInjector(seed=seed)
        ref = ref_faults.FaultInjector(seed=seed)
        legacy = np.random.default_rng(seed)
        draws = inj.rng.random(8)
        assert np.array_equal(draws, legacy.random(8))
        assert np.array_equal(draws, ref.rng.random(8))
        assert inj.thread_index() == 0


def test_perturbation_is_the_reference_s():
    """``perturb`` adds scale * the calling thread's normal draws: the
    same array as the reference's, call for call."""
    arr = np.arange(12.0).reshape(3, 4)
    arms = {faults.BINV: dict(times=2, after=1, scale=1e-3)}
    got = []
    for fl in (faults, ref_faults):
        with fl.injected(seed=9, arms=arms):
            got.append([fl.perturb(fl.BINV, arr) for _ in range(4)])
    for a, b in zip(*got):
        assert np.array_equal(a, b)
    assert got[0][0] is arr and got[0][3] is arr   # skipped, then capped
    assert not np.array_equal(got[0][1], arr)


def test_faults_two_thread_streams_deterministic():
    """Each thread gets its own deterministic stream: per-thread draw
    sequences equal the spawned SeedSequence streams regardless of
    interleaving, and per-thread fire budgets apply independently."""
    site = "test.site"

    def expected(idx, seed=9):
        ss = np.random.SeedSequence(seed) if idx == 0 \
            else np.random.SeedSequence(seed, spawn_key=(idx - 1,))
        return np.random.default_rng(ss).random(4)

    for trial in range(3):                     # stable across repeats
        inj = faults.FaultInjector(seed=9).arm(site, times=1)

        def body():
            fires = 0
            for _ in range(3):                 # budget is per-thread
                try:
                    inj.maybe_raise(site)
                except OSError:
                    fires += 1
            return inj.thread_index(), tuple(inj.rng.random(4)), fires

        out = run_threads([body, body])
        idxs = sorted(t[0] for t in out)
        assert idxs == [0, 1], "each thread must own a distinct stream"
        for idx, draws, fires in out:
            assert np.array_equal(draws, expected(idx))
            assert fires == 1                  # times=1 PER THREAD
        assert inj.fire_count(site) == 2       # aggregate across streams
        assert sorted(s for _site, s, _k in inj.log) == [0, 1]


def test_faults_thread_scoped_injection_is_confined():
    site = "test.scoped"
    ev_armed = threading.Event()
    ev_checked = threading.Event()

    def armed_thread():
        with faults.injected(seed=1, arms={site: dict(times=1)},
                             scope="thread") as inj:
            with pytest.raises(OSError):
                inj.maybe_raise(site)
            ev_armed.set()
            assert ev_checked.wait(10)
            return inj.fire_count(site)

    def other_thread():
        assert ev_armed.wait(10)
        assert faults.get() is None            # activation never leaks
        faults.maybe_raise(site)               # must be a no-op
        ev_checked.set()
        return True

    fired, ok = run_threads([armed_thread, other_thread])
    assert fired == 1 and ok is True
    assert faults.get() is None


def test_injected_nests_and_restores():
    with faults.injected(seed=1) as outer:
        assert faults.get() is outer
        with faults.injected(seed=2) as inner:
            assert faults.get() is inner
        assert faults.get() is outer
    assert faults.get() is None
    with pytest.raises(ValueError, match="scope"):
        with faults.injected(scope="galaxy"):
            pass
