"""The port's race harness (``repro_torch.runtime.racecheck``) and its
``BoundedStepCache`` (``repro_torch.core.distributed``), held to the
reference's cases (``tests/test_concurrency.py``) with the same seeds and
schedules: a pinned known-bad schedule reproduces the duplicate-build
race on an unlocked cache double, the serial schedule does not, every
seed replays exactly; the step cache builds each key once under a
preemptive hammer and under every seeded schedule; the instrumented lock
counts and the controller detects a self-deadlock.  Where the reference's
harness gives a trace for the same seed, the port's gives the same one.
"""
import threading

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
