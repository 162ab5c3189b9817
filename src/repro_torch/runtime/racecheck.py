"""Deterministic race harness + instrumented locks (port of
``repro.runtime.racecheck``, pure Python and threading, kept as the
port's own copy).

The port's shared-state classes (``core.distributed.BoundedStepCache``
today; the query cache and the scheduler as they are ported) carry locks
and a ``__guarded_by__`` contract.  A lock is easy to *add* and hard to
*trust*: a plain multi-threaded test only explores whatever
interleavings the OS scheduler happens to produce that day.  This module
makes interleavings a controlled input:

* :func:`checkpoint` — registered shared-state touchpoints in production
  code (one module-global read when inactive).
  ``BoundedStepCache.get_or_create`` calls it.
* :class:`InstrumentedLock` / :class:`InstrumentedRLock` — drop-in
  ``threading`` locks that (a) count acquisitions / contention and
  accumulate hold/wait time and (b) cooperate with an active schedule
  controller, yielding instead of blocking so a forced schedule can
  never self-deadlock on a parked lock holder.
* :class:`ScheduleController` — runs N thread bodies with exactly ONE
  running at a time; at every checkpoint the controller decides, from a
  seed or an explicit schedule list, which thread runs next.  Given the
  same seed/schedule and code paths the interleaving replays exactly, so
  a race is a *reproducible test failure*: the known-bad interleaving on
  an unlocked cache double must fail, and the fixed class must pass
  every seeded schedule (see ``tests/test_torch_concurrency.py``).
* :func:`guarded_by` — marker decorator declaring that a method must be
  called with the named lock held; for readers of the code (the
  reference's static checker reads it there).

Determinism argument: only one managed thread executes at a time, every
switch decision is drawn from the controller's seeded rng (or the pinned
schedule) under the controller mutex, and the sequence of checkpoint
calls is a pure function of the code paths taken — so the full
interleaving is a pure function of (seed, code).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

_TLS = threading.local()          # .slot = managed-thread index

# Active controller: rebinding is guarded; production reads are a single
# unlocked poll (exactly like runtime.faults._ACTIVE).
SHARED_MUTABLE = ("_CONTROLLER",)   # REPRO010 registry

_CONTROLLER: Optional["ScheduleController"] = None
_CONTROLLER_LOCK = threading.Lock()


def guarded_by(lock_name: str) -> Callable:
    """Declare that a function/method must run with ``lock_name`` held by
    the caller.  A no-op marker at runtime; the static checker
    (REPRO008) treats the body as lock-protected."""
    def deco(fn):
        fn.__guarded_by__ = str(lock_name)
        return fn
    return deco


def controller() -> Optional["ScheduleController"]:
    return _CONTROLLER


def install(ctl: Optional["ScheduleController"]
            ) -> Optional["ScheduleController"]:
    """Install (or clear) the active controller; returns the previous
    one so nesting restores correctly."""
    global _CONTROLLER
    with _CONTROLLER_LOCK:
        prev, _CONTROLLER = _CONTROLLER, ctl
    return prev


def checkpoint(site: str) -> None:
    """Shared-state touchpoint.  No-op unless a schedule controller is
    active AND the calling thread is managed by it."""
    ctl = _CONTROLLER
    if ctl is not None:
        ctl._checkpoint(site)


class Deadlock(RuntimeError):
    """A forced schedule cannot make progress (or ran away)."""


def wait_event(ev: threading.Event, site: str = "event.wait",
               timeout: Optional[float] = None) -> bool:
    """Controller-cooperative ``Event.wait``.

    Managed threads must never block the OS thread on an event another
    *parked* managed thread is responsible for setting — that would
    deadlock the forced schedule.  Under a controller the wait becomes a
    poll-and-yield loop (the setter gets scheduled eventually); without
    one it is a plain ``ev.wait(timeout)``."""
    ctl = _CONTROLLER
    if ctl is not None and ctl._managed():
        spins = 0
        while not ev.is_set():
            ctl._yield_blocked(site)
            spins += 1
            if spins > ctl.max_switches:
                raise Deadlock(f"{site}: event never set")
        return True
    return ev.wait(timeout)


# ------------------------------------------------------------------ locks


class InstrumentedLock:
    """``threading.Lock`` with contention/hold-time counters and
    controller cooperation.

    Counters (``stats()``): ``acquisitions``, ``contended`` (acquire
    found the lock held), ``wait_s`` (time spent blocked acquiring),
    ``hold_s`` (outermost-hold wall time).  The counters themselves are
    guarded by a private meter lock, so reads are never torn.

    Under an active :class:`ScheduleController`, a blocked acquire
    *yields to another managed thread* instead of blocking the OS
    thread — the lock holder is parked and must be scheduled to ever
    release, so cooperative yielding is what makes lock-based code
    explorable without deadlock.
    """

    _reentrant = False

    def __init__(self, name: str = "lock"):
        self.name = name
        self._inner = self._make_inner()
        self._meter = threading.Lock()
        self.acquisitions = 0
        self.contended = 0
        self.wait_s = 0.0
        self.hold_s = 0.0
        self._depth = 0            # guarded by holding the lock itself
        self._acquired_at = 0.0

    def _make_inner(self):
        return threading.Lock()

    def acquire(self) -> bool:
        ctl = _CONTROLLER
        if ctl is not None:
            ctl._checkpoint(f"lock:{self.name}")
        t0 = time.perf_counter()
        got = self._inner.acquire(blocking=False)
        contended = not got
        if not got:
            if ctl is not None and ctl._managed():
                spins = 0
                while not self._inner.acquire(blocking=False):
                    ctl._yield_blocked(f"lock:{self.name}")
                    spins += 1
                    if spins > ctl.max_switches:
                        raise Deadlock(f"lock:{self.name} never released")
            else:
                self._inner.acquire()
        wait = time.perf_counter() - t0
        with self._meter:
            self.acquisitions += 1
            if contended:
                self.contended += 1
            self.wait_s += wait
        if self._depth == 0:       # we own the lock: private fields safe
            self._acquired_at = time.perf_counter()
        self._depth += 1
        return True

    def release(self) -> None:
        self._depth -= 1
        held = time.perf_counter() - self._acquired_at \
            if self._depth == 0 else None
        self._inner.release()
        if held is not None:
            with self._meter:
                self.hold_s += held
        ctl = _CONTROLLER
        if ctl is not None:
            ctl._checkpoint(f"unlock:{self.name}")

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def stats(self) -> dict:
        with self._meter:
            return {"name": self.name, "acquisitions": self.acquisitions,
                    "contended": self.contended,
                    "wait_s": self.wait_s, "hold_s": self.hold_s}

    def reset_stats(self) -> None:
        with self._meter:
            self.acquisitions = 0
            self.contended = 0
            self.wait_s = 0.0
            self.hold_s = 0.0


class InstrumentedRLock(InstrumentedLock):
    """Reentrant variant (``threading.RLock`` semantics).  Re-acquiring
    while owning never contends and never yields to the controller."""

    _reentrant = True

    def _make_inner(self):
        return threading.RLock()

    def acquire(self) -> bool:
        # A reentrant re-acquire by the owner must not try-fail-yield:
        # the non-blocking probe succeeds for the owner, so the base
        # implementation is correct as long as depth tracking is ours.
        return super().acquire()


# ------------------------------------------------------- schedule control


class ScheduleController:
    """Deterministic cooperative scheduler for race tests.

    ``run(fns)`` starts one real thread per body but grants execution to
    exactly one at a time.  At every :func:`checkpoint` (and every
    instrumented lock edge) the controller picks the next thread to run:
    from ``schedule`` — a pinned list of thread indices consumed one
    decision at a time (the first entry picks the starting thread) — or
    from the seeded rng once the list (if any) is exhausted.  Unmanaged
    threads (e.g. the pytest main thread) pass checkpoints untouched.

    ``trace`` records every ``(site, chosen_thread)`` decision so a
    failing seed can be pinned as an explicit schedule.
    """

    def __init__(self, seed: int = 0,
                 schedule: Optional[Sequence[int]] = None,
                 max_switches: int = 100_000):
        self.rng = np.random.default_rng(seed)
        self.schedule: List[int] = [] if schedule is None \
            else [int(s) for s in schedule]
        self.max_switches = int(max_switches)
        self.switches = 0
        self.trace: List[tuple] = []
        self._mtx = threading.Lock()
        self._gates: List[threading.Event] = []
        self._done: List[bool] = []
        self._errors: List[Optional[BaseException]] = []
        self._results: List[object] = []

    # ------------------------------------------------------------ internal

    def _managed(self) -> bool:
        return getattr(_TLS, "slot", None) is not None

    @guarded_by("_mtx")
    def _alive(self) -> List[int]:
        return [i for i, d in enumerate(self._done) if not d]

    @guarded_by("_mtx")
    def _choose(self, runnable: List[int], site: str) -> int:
        self.switches += 1
        if self.switches > self.max_switches:
            raise Deadlock(f"runaway schedule at {site!r} "
                           f"({self.switches} switches)")
        if self.schedule:
            want = self.schedule.pop(0)
            choice = want if want in runnable else runnable[0]
        else:
            choice = int(runnable[int(self.rng.integers(len(runnable)))])
        self.trace.append((site, choice))
        return choice

    def _switch(self, site: str, candidates_of) -> None:
        """Common checkpoint body: pick who runs next; park if not us."""
        i = getattr(_TLS, "slot", None)
        if i is None:
            return
        with self._mtx:
            runnable = candidates_of(i)
            if not runnable:
                raise Deadlock(f"{site}: no runnable thread to yield to")
            j = self._choose(runnable, site)
            if j == i:
                return
            self._gates[j].set()
            self._gates[i].clear()
        self._gates[i].wait()

    def _checkpoint(self, site: str) -> None:
        self._switch(site, lambda i: self._alive())

    def _yield_blocked(self, site: str) -> None:
        """The calling thread CANNOT progress (lock held elsewhere):
        grant someone else unconditionally."""
        self._switch(site, lambda i: [t for t in self._alive() if t != i])

    # -------------------------------------------------------------- public

    def run(self, fns: Sequence[Callable[[], object]],
            timeout_s: float = 30.0) -> List[object]:
        """Run the bodies to completion under the schedule; returns their
        results in order.  Re-raises the first body exception; raises
        :class:`Deadlock` on timeout (a schedule that cannot finish)."""
        n = len(fns)
        self._gates = [threading.Event() for _ in range(n)]
        self._done = [False] * n
        self._errors = [None] * n
        self._results = [None] * n

        def _body(i: int, fn: Callable[[], object]) -> None:
            _TLS.slot = i
            self._gates[i].wait()
            try:
                self._results[i] = fn()
            # repro: allow[REPRO004] harness thread body: the error is
            # recorded and RE-RAISED by run() on the caller's thread
            except BaseException as e:      # surfaced to run()'s caller
                self._errors[i] = e
            finally:
                _TLS.slot = None
                with self._mtx:
                    self._done[i] = True
                    rest = self._alive()
                    if rest:
                        self._gates[self._choose(rest, "exit")].set()

        threads = [threading.Thread(target=_body, args=(i, fn),
                                    daemon=True, name=f"racecheck-{i}")
                   for i, fn in enumerate(fns)]
        prev = install(self)
        try:
            for t in threads:
                t.start()
            with self._mtx:
                self._gates[self._choose(list(range(n)), "start")].set()
            deadline = time.monotonic() + timeout_s
            for t in threads:
                t.join(max(0.0, deadline - time.monotonic()))
            if any(t.is_alive() for t in threads):
                raise Deadlock(
                    f"schedule did not complete in {timeout_s}s; "
                    f"trace tail: {self.trace[-8:]}")
        finally:
            install(prev)
        for e in self._errors:
            if e is not None:
                raise e
        return list(self._results)


def run_schedules(make_case: Callable[[], Sequence[Callable[[], object]]],
                  seeds: Sequence[int] = range(16),
                  timeout_s: float = 30.0) -> List["ScheduleController"]:
    """Sweep seeded schedules: for each seed, build a FRESH case (state +
    thread bodies) and run it under a fresh controller.  Returns the
    controllers (for trace/switch inspection); raises on the first seed
    whose schedule fails — the seed is in the exception message so the
    failure replays exactly."""
    out = []
    for seed in seeds:
        ctl = ScheduleController(seed=seed)
        try:
            ctl.run(make_case(), timeout_s=timeout_s)
        # repro: allow[REPRO004] harness loop: re-raised as an
        # AssertionError naming the failing seed (replayable)
        except BaseException as e:
            raise AssertionError(
                f"schedule seed={seed} failed: {type(e).__name__}: {e}"
            ) from e
        out.append(ctl)
    return out


def run_threads(fns: Sequence[Callable[[], object]],
                timeout_s: float = 60.0) -> List[object]:
    """Plain preemptive-concurrency helper (hammer tests): run bodies on
    real threads simultaneously, join, re-raise the first exception."""
    n = len(fns)
    results: List[object] = [None] * n
    errors: List[Optional[BaseException]] = [None] * n
    start = threading.Barrier(n)

    def _body(i: int, fn: Callable[[], object]) -> None:
        try:
            start.wait(timeout_s)
            results[i] = fn()
        # repro: allow[REPRO004] harness thread body: first error is
        # re-raised by run_threads() on the caller's thread
        except BaseException as e:
            errors[i] = e

    threads = [threading.Thread(target=_body, args=(i, fn), daemon=True)
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
    if any(t.is_alive() for t in threads):
        raise Deadlock(f"threads did not finish in {timeout_s}s")
    for e in errors:
        if e is not None:
            raise e
    return results
