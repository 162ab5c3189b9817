"""The port's race harness (``repro_torch.runtime.racecheck``), its
``BoundedStepCache`` (``repro_torch.core.distributed``) and its
``QCache`` (``repro_torch.core.qcache``), held to the reference's cases
(``tests/test_concurrency.py``) with the same seeds and schedules: a
pinned known-bad schedule reproduces the duplicate-build race on an
unlocked cache double, the serial schedule does not, every seed replays
exactly; the step cache builds each key once under a preemptive hammer
and under every seeded schedule; the query cache's claim protocol runs
one cold solve per key under every seeded schedule; the instrumented
lock counts and the controller detects a self-deadlock; concurrent
engine sessions over one shared cache return the packages of sequential
solves.  Where the reference's harness gives a trace for the same seed,
the port's gives the same one.
"""
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from repro.runtime import racecheck as ref_racecheck
from repro_torch.core.distributed import BoundedStepCache
from repro_torch.runtime import racecheck
from repro_torch.runtime.racecheck import (Deadlock, InstrumentedLock,
                                           InstrumentedRLock,
                                           ScheduleController, run_threads)


class _UnlockedCacheDouble:
    """A get-or-populate WITHOUT a claim protocol: probe and store are
    separate unlocked steps, so two threads interleaved between them both
    run the cold solve."""

    def __init__(self, rc=racecheck):
        self.rc = rc
        self.entries = {}
        self.solves = 0

    def get_or_populate(self, key, solve):
        self.rc.checkpoint("double.probe")
        if key in self.entries:
            return "hit", self.entries[key]
        self.rc.checkpoint("double.solve")
        v = solve()
        self.solves += 1
        self.rc.checkpoint("double.store")
        self.entries[key] = v
        return "solved", v


# the reference's pinned known-bad interleaving and its serial schedule
_BAD_SCHEDULE = [0, 1, 1, 1, 0, 0, 0]
_SERIAL_SCHEDULE = [0] * 16


def _double_case(rc=racecheck):
    cache = _UnlockedCacheDouble(rc)

    def body():
        return cache.get_or_populate("k", lambda: "v")[0]

    return cache, [body, body]


def test_pinned_schedule_reproduces_unlocked_race():
    cache, fns = _double_case()
    ctl = ScheduleController(schedule=list(_BAD_SCHEDULE))
    kinds = ctl.run(fns)
    assert cache.solves == 2, \
        f"known-bad schedule must duplicate the cold solve; {ctl.trace}"
    assert kinds == ["solved", "solved"]


def test_serial_schedule_passes_unlocked_double():
    cache, fns = _double_case()
    kinds = ScheduleController(schedule=list(_SERIAL_SCHEDULE)).run(fns)
    assert cache.solves == 1
    assert sorted(kinds) == ["hit", "solved"]


def test_seeded_schedules_replay_exactly():
    """Same seed => same interleaving => same outcome, the reference's
    interleaving too; the sweep sees both clean and racy seeds."""
    outcomes = {}
    for seed in range(24):
        runs = []
        for _ in range(2):
            cache, fns = _double_case()
            ctl = ScheduleController(seed=seed)
            ctl.run(fns)
            runs.append((cache.solves, tuple(ctl.trace)))
        assert runs[0] == runs[1], f"seed {seed} did not replay"
        ref_cache, ref_fns = _double_case(ref_racecheck)
        ref_ctl = ref_racecheck.ScheduleController(seed=seed)
        ref_ctl.run(ref_fns)
        assert runs[0] == (ref_cache.solves, tuple(ref_ctl.trace)), seed
        outcomes[seed] = runs[0][0]
    assert set(outcomes.values()) == {1, 2}, \
        f"sweep should see both clean and racy interleavings: {outcomes}"


def test_step_cache_hammer_counter_invariant():
    """8 preemptive threads over 6 overlapping keys: each key is built
    exactly once (claim token), and hits + misses == lookups."""
    cache = BoundedStepCache(maxsize=64)
    built = []
    build_lock = threading.Lock()

    def body(t):
        def run():
            out = []
            for rep in range(5):
                for k in range(6):
                    def factory(k=k):
                        with build_lock:
                            built.append(k)
                        return ("steps", k)

                    out.append(cache.get_or_create(("key", k), factory))
            return out

        return run

    results = run_threads([body(t) for t in range(8)])
    assert sorted(built) == list(range(6)), \
        f"every key must be built exactly once, got {built}"
    st = cache.stats()
    assert st["hits"] + st["misses"] == st["lookups"]
    assert st["misses"] == 6 and st["lookups"] == 8 * 5 * 6
    for out in results:
        assert out == [("steps", k) for _ in range(5) for k in range(6)]


def test_step_cache_atomic_under_schedules():
    cases = []

    def make_case():
        cache = BoundedStepCache(maxsize=8)
        built = []
        cases.append((cache, built))

        def body():
            return cache.get_or_create(
                "k", lambda: built.append(1) or "entry")

        return [body, body, body]

    ctls = racecheck.run_schedules(make_case, seeds=range(10))
    assert len(ctls) == len(cases) == 10
    for cache, built in cases:
        assert len(built) == 1                 # one build per schedule
        st = cache.stats()
        assert st["hits"] + st["misses"] == st["lookups"] == 3


def test_step_cache_evicts_and_releases_a_failed_build():
    """LRU eviction is counted, and a factory that raises releases its
    claim (the next caller builds) instead of parking waiters."""
    cache = BoundedStepCache(maxsize=2)
    for k in range(3):
        cache.get_or_create(k, lambda k=k: k)
    assert cache.stats()["evictions"] == 1 and len(cache) == 2

    def boom():
        raise RuntimeError("build failed")

    with pytest.raises(RuntimeError):
        cache.get_or_create("x", boom)
    assert cache.get_or_create("x", lambda: "ok") == "ok"


def test_instrumented_lock_contention_counters():
    lk = InstrumentedLock("bench")
    held = []

    def body():
        for _ in range(50):
            with lk:
                held.append(1)
        return True

    run_threads([body] * 4)
    st = lk.stats()
    assert st["acquisitions"] == 200 and len(held) == 200
    assert 0 <= st["contended"] <= 200
    assert st["wait_s"] >= 0.0 and st["hold_s"] >= 0.0
    lk.reset_stats()
    assert lk.stats()["acquisitions"] == 0


def test_instrumented_rlock_reenters():
    lk = InstrumentedRLock("re")
    with lk:
        with lk:
            pass
    assert lk.stats()["acquisitions"] == 2


def test_controller_detects_self_deadlock():
    lk = InstrumentedLock("stuck")
    lk.acquire()                               # held by the main thread

    def body():
        with lk:
            return True

    with pytest.raises(Deadlock):
        ScheduleController(seed=0, max_switches=500).run([body],
                                                         timeout_s=5)
    lk.release()


# ------------------------------------ the batched LP engine's class workspace


def _lp_flight(seed, K=6, n=30, m=3):
    """One shared (c, A, bl, bu) and K feasible bound-variants; every seed
    gives the same shape class (m_pad, n_pad, K_pad)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    c, A = rng.normal(size=n), rng.normal(size=(m, n))
    ub = rng.integers(1, 4, size=n).astype(float)
    act = A @ (rng.uniform(0, 1, n) * ub)
    wid = np.abs(rng.normal(size=m)) * 2 + 0.5
    return (c, A, act - wid, act + wid,
            [ub * rng.uniform(0.5, 1.0, n) for _ in range(K)])


def _same_results(got, want):
    import numpy as np
    assert [(g.status, g.iters, g.notes) for g in got] == \
        [(w.status, w.iters, w.notes) for w in want]
    for g, w in zip(got, want):
        assert g.obj == w.obj and np.array_equal(g.x, w.x)
        assert np.array_equal(g.basis, w.basis)


def _kept_packs(seeds):
    """The (solver, cf, A, in pack) each seed's flight gives the class's
    LaneSolver (on the CPU), and the solver's out pack for it."""
    from repro_torch.core.lp_batch import solve_lp_batch
    from repro_torch.kernels import lp_batch as kl
    kept = []
    call = kl.LaneSolver.__call__

    def keep(self, cf, A, in_pack):
        out = call(self, cf, A, in_pack)
        kept.append((self, cf, A, in_pack.copy(), out.copy()))
        return out

    kl.LaneSolver.__call__ = keep
    try:
        for seed in seeds:
            solve_lp_batch(*_lp_flight(seed), backend="device",
                           device="cpu")
    finally:
        kl.LaneSolver.__call__ = call
    return kept


def test_lane_solver_concurrent_dispatches_of_one_class():
    """Four threads dispatch flights of one shape class through the
    engine at once: they share one cached LaneSolver, each call takes its
    lock once, and every thread gets its own flight's lanes, equal to a
    dispatch of that flight alone."""
    from repro_torch.core import lp_batch as core
    seeds = range(4)
    want = {s: core.solve_lp_batch(*_lp_flight(s), backend="device",
                                   device="cpu") for s in seeds}
    kept = _kept_packs(seeds)
    solver = kept[0][0]
    assert all(k[0] is solver for k in kept)
    solver._lock.reset_stats()

    def body(seed):
        return lambda: [core.solve_lp_batch(*_lp_flight(seed),
                                            backend="device", device="cpu")
                        for _ in range(3)]

    results = run_threads([body(s) for s in seeds])
    for s, runs in zip(seeds, results):
        for got in runs:
            _same_results(got, want[s])
    assert solver._lock.stats()["acquisitions"] == 4 * 3


def test_lane_solver_call_is_atomic_under_schedules(monkeypatch):
    """Under every seeded schedule two threads' calls on one LaneSolver
    never overlap (the plain solve is entered by one at a time, with a
    switch point inside it) and each returns its own out pack; with the
    lock taken away the same schedules do overlap, so the check can
    fail."""
    import numpy as np
    from repro_torch.kernels import lp_batch as kl
    kept = _kept_packs([0, 1])
    solver = kept[0][0]
    assert kept[1][0] is solver
    real = kl.lp_batch_plain
    inside = {"now": 0, "most": 0}

    def plain(*a, **kw):
        inside["now"] += 1
        inside["most"] = max(inside["most"], inside["now"])
        racecheck.checkpoint("plain.mid")
        try:
            return real(*a, **kw)
        finally:
            inside["now"] -= 1

    monkeypatch.setattr(kl, "lp_batch_plain", plain)

    most = []
    for seed in range(8):
        inside["most"] = 0
        res = ScheduleController(seed=seed).run([
            (lambda i=i: solver(*kept[i][1:4])) for i in range(2)])
        most.append(inside["most"])
        for i in range(2):
            assert np.array_equal(res[i], kept[i][4])
    assert most == [1] * 8

    class _NoLock:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

    monkeypatch.setattr(solver, "_lock", _NoLock())
    overlapped = []
    for seed in range(8):
        inside["most"] = 0
        ScheduleController(seed=seed).run([
            (lambda i=i: solver(*kept[i][1:4])) for i in range(2)])
        overlapped.append(inside["most"])
    assert max(overlapped) == 2


# --------------------------------------------------------- the QCache


class _FakeHier:
    """Just enough hierarchy for QCache.store: a fingerprint, layer-1
    group ids, and a no-op invalidation hook."""

    def __init__(self, fingerprint="fp0"):
        self.fingerprint = fingerprint
        self.layers = {1: SimpleNamespace(
            part=SimpleNamespace(gid=np.zeros(64, np.int64)))}

    def add_invalidation_hook(self, fn):
        pass


class _Sig:
    def __init__(self, tag):
        self.tag = tag

    def __hash__(self):
        return hash(self.tag)

    def __eq__(self, other):
        return isinstance(other, _Sig) and self.tag == other.tag

    def contained_in(self, other):
        return self == other


def _qcache_case(QCache, n_threads=3):
    qc = QCache()
    hier = _FakeHier()
    sig = _Sig("q")
    solves = []

    def body():
        def solve():
            solves.append(1)
            qc.store("fp0", sig, hier=hier, cands={1: np.arange(8)},
                     layer_warms={}, dr_warm=None, lp_bound=1.0)
            return "cold"

        kind, _val = qc.get_or_populate("fp0", sig, solve)
        return kind

    return qc, solves, [body] * n_threads


@pytest.mark.parametrize("seed", range(12))
def test_qcache_get_or_populate_atomic_under_schedule(seed):
    """The claim protocol: every seeded interleaving runs exactly ONE cold
    solve and every other session takes the hit; the interleaving and
    the counters are the reference's for the same seed."""
    from repro.core.qcache import QCache as RefQCache
    from repro_torch.core.qcache import QCache
    qc, solves, fns = _qcache_case(QCache)
    ctl = ScheduleController(seed=seed)
    kinds = ctl.run(fns, timeout_s=30)
    assert sum(solves) == 1, f"seed {seed}: duplicate cold solve"
    assert sorted(kinds) == ["hit", "hit", "solved"]
    assert len(qc) == 1
    st = qc.stats_snapshot()
    assert st.stores == 1 and st.hits >= 2
    ref_qc, ref_solves, ref_fns = _qcache_case(RefQCache)
    ref_ctl = ref_racecheck.ScheduleController(seed=seed)
    assert ref_ctl.run(ref_fns, timeout_s=30) == kinds
    assert ref_ctl.trace == ctl.trace
    assert ref_qc.stats_snapshot().as_dict() == st.as_dict()


def test_qcache_populate_protocol_single_thread():
    from repro_torch.core.qcache import QCache
    qc = QCache()
    sig = _Sig("a")
    assert qc.begin_populate("fp", sig) is True
    assert qc.begin_populate("fp", sig) is False      # already claimed
    assert qc.wait_populate("fp", sig, timeout=0.01) is False
    qc.end_populate("fp", sig)
    assert qc.wait_populate("fp", sig, timeout=0.01) is True
    assert qc.begin_populate("fp", sig) is True       # claim reusable
    qc.end_populate("fp", sig)


def test_qcache_failed_solve_releases_claim():
    from repro_torch.core.qcache import QCache
    qc, _solves, _fns = _qcache_case(QCache)
    sig = _Sig("q")

    def boom():
        raise RuntimeError("cold solve died")

    with pytest.raises(RuntimeError):
        qc.get_or_populate("fp0", sig, boom)
    # the claim is released: the next caller becomes the owner
    assert qc.begin_populate("fp0", sig) is True
    qc.end_populate("fp0", sig)


def test_qcache_lock_stats_counters():
    from repro_torch.core.qcache import QCache
    qc, _solves, fns = _qcache_case(QCache)
    ScheduleController(seed=3).run(fns)
    ls = qc.lock_stats()
    assert ls["name"] == "qcache"
    assert ls["acquisitions"] > 0
    assert ls["wait_s"] >= 0.0 and ls["hold_s"] >= 0.0


# ------------------------------------------- sessions over one shared cache


def _pkg(res):
    order = np.argsort(res.idx, kind="stable")
    return np.asarray(res.idx)[order], np.asarray(res.mult)[order]


def test_engine_concurrent_sessions_match_sequential():
    """Concurrent sessions over ONE shared engine + QCache return the same
    packages as sequential solves of the same queries, which are the
    reference's."""
    from repro.core.engine import PackageQueryEngine as RefEngine
    from repro.core import hardness as ref_hardness
    from repro.core.qcache import QCache as RefQCache
    from repro_torch.core import hardness
    from repro_torch.core.engine import PackageQueryEngine
    from repro_torch.core.qcache import QCache
    from repro_torch.data.synth_tables import make_table
    attrs = ["price", "quantity", "discount", "tax"]
    ilp_kw = dict(max_nodes=200, time_limit_s=15)
    table = make_table("tpch", 4_000, seed=1)

    def queries(hd):
        stats = hd.column_stats(table, attrs)
        return [hd.instantiate(hd.Q2_TPCH, stats, 2.0),
                hd.instantiate(hd.Q4_TPCH, stats, 2.0)]

    def build():
        return PackageQueryEngine(table, attrs, d_f=20, alpha=600, seed=0,
                                  cache=QCache(), device="cpu").partition()

    qs = queries(hardness)
    seq = build()
    baseline = [seq.session(seed=100 + i).solve(q, ilp_kwargs=ilp_kw)
                for i, q in enumerate(qs)]
    assert all(r.feasible for r in baseline)
    ref = RefEngine(table, attrs, d_f=20, alpha=600, seed=0,
                    cache=RefQCache()).partition()
    for i, q in enumerate(queries(ref_hardness)):
        want = ref.session(seed=100 + i).solve(q, ilp_kwargs=ilp_kw)
        for got, w in zip(_pkg(baseline[i]), _pkg(want)):
            assert np.array_equal(got, w)

    conc = build()

    def body(i):
        def run():
            # two sessions per query, same seeds as the baseline pass
            return conc.session(seed=100 + (i % 2)).solve(
                qs[i % 2], ilp_kwargs=ilp_kw)

        return run

    results = run_threads([body(i) for i in range(4)], timeout_s=300)
    for i, res in enumerate(results):
        assert res.feasible, f"thread {i} infeasible: {res.status}"
        want_idx, want_mult = _pkg(baseline[i % 2])
        got_idx, got_mult = _pkg(res)
        assert np.array_equal(got_idx, want_idx)
        assert np.array_equal(got_mult, want_mult)
        # same package, so obj may differ only by summation order
        assert np.isclose(res.obj, baseline[i % 2].obj, rtol=1e-12)
    st = conc.cache.stats_snapshot()
    assert st.stores >= 1
    assert st.hits + st.misses >= len(results)
