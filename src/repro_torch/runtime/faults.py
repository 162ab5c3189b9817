"""Deterministic, seed-driven fault injection (port of
``repro.runtime.faults``, host numpy as there).

Every fallback the Solve Guard promises (``core.guard``) is pinned by a
test that *forces* the failure it handles.  This module is the forcing
side: a process-global :class:`FaultInjector` that production code polls
at a handful of named sites, each a single cheap call that is a no-op
when no injector is active:

* ``relation.chunk_read`` / ``relation.gather`` — raise a transient
  ``OSError`` inside a Relation chunk/gather read (``core.relation``
  retries with capped exponential backoff);
* ``lp.binv``   — perturb the maintained basis inverse inside
  ``solve_lp_np`` (forcing the NumericalMonitor drift path);
* ``dist.shard`` — raise inside the ``solve_lp_dist`` pivot loop,
  standing in for a dead mesh shard (forcing the single-host fallback).
  Defined here but polled nowhere yet: the distributed pivot loop is
  ROADMAP queue 1, item 6, and its site comes with it.

Determinism — now per *thread*: each thread that touches an injector is
lazily assigned a stream in registration order; stream 0 draws from
``SeedSequence(seed)`` (bit-identical to the historical single-thread
``default_rng(seed)`` behaviour) and stream ``k`` from
``SeedSequence(seed, spawn_key=(k-1,))``.  Opportunity counters
(``after`` skips, ``times`` caps) and probability draws are per-stream,
so concurrent sessions see independent, seed-reproducible fault
schedules instead of racing over one shared rng.  Aggregate counters
(``fire_count``, ``log``) are kept under the injector lock.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.runtime import racecheck

# ------------------------------------------------------------ site names

CHUNK_READ = "relation.chunk_read"
GATHER_READ = "relation.gather"
BINV = "lp.binv"
# polled by the distributed pivot loop, which comes with ROADMAP queue 1,
# item 6 (distributed pricing); until then it never fires
SHARD = "dist.shard"


@dataclasses.dataclass
class FaultSpec:
    """When/how one site fires.

    ``after`` opportunities are skipped, then up to ``times`` fires (None
    = unlimited), each gated by ``prob`` — all evaluated against the
    *calling thread's* stream, so each thread replays its own schedule.
    ``scale`` is the magnitude for perturbation sites.
    """
    prob: float = 1.0
    times: Optional[int] = 1
    after: int = 0
    scale: float = 1e-3
    message: str = "injected fault"


class _Stream:
    """Per-thread rng + opportunity counters (thread-confined: only the
    owning thread ever touches ``rng``/``seen``/``fired``)."""

    __slots__ = ("idx", "rng", "seen", "fired")

    def __init__(self, idx: int, seed: int):
        self.idx = idx
        if idx == 0:
            ss = np.random.SeedSequence(seed)
        else:
            ss = np.random.SeedSequence(seed, spawn_key=(idx - 1,))
        self.rng = np.random.default_rng(ss)
        self.seen: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}


class FaultInjector:

    __guarded_by__ = {"specs": "_lock", "seen": "_lock", "fired": "_lock",
                      "log": "_lock", "_streams": "_lock"}

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.specs: Dict[str, FaultSpec] = {}
        # Aggregate (all-thread) counters; per-thread schedules live on
        # the thread's _Stream.
        self.seen: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}
        self.log: List[Tuple[str, int, int]] = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._streams: List[_Stream] = []

    # ---------------------------------------------------------- streams

    def _stream(self) -> _Stream:
        st = getattr(self._tls, "stream", None)
        if st is None:
            with self._lock:
                st = _Stream(len(self._streams), self.seed)
                self._streams.append(st)
            self._tls.stream = st
        return st

    @property
    def rng(self) -> np.random.Generator:
        """The calling thread's generator (compat accessor)."""
        return self._stream().rng

    def thread_index(self) -> int:
        """Registration index of the calling thread's stream."""
        return self._stream().idx

    # ------------------------------------------------------------ set-up

    def arm(self, site: str, **kw) -> "FaultInjector":
        with self._lock:
            self.specs[site] = FaultSpec(**kw)
            self.seen[site] = 0
            self.fired[site] = 0
        return self

    def fire_count(self, site: str) -> int:
        """Total fires across all threads."""
        with self._lock:
            return self.fired.get(site, 0)

    def stream_fire_count(self, site: str) -> int:
        """Fires seen by the calling thread's own stream."""
        return self._stream().fired.get(site, 0)

    # ------------------------------------------------------------ firing

    def _should_fire(self, site: str) -> Optional[FaultSpec]:
        spec = self.specs.get(site)
        if spec is None:
            return None
        st = self._stream()
        racecheck.checkpoint(f"faults:{site}")
        # Schedule decisions are thread-confined (per-stream counters and
        # rng); only the aggregate tallies need the lock.
        k = st.seen.get(site, 0)
        st.seen[site] = k + 1
        with self._lock:
            self.seen[site] = self.seen.get(site, 0) + 1
        if k < spec.after:
            return None
        if spec.times is not None and st.fired.get(site, 0) >= spec.times:
            return None
        if spec.prob < 1.0 and st.rng.random() >= spec.prob:
            return None
        st.fired[site] = st.fired.get(site, 0) + 1
        with self._lock:
            self.fired[site] = self.fired.get(site, 0) + 1
            self.log.append((site, st.idx, k))
        return spec

    def maybe_raise(self, site: str, exc=OSError) -> None:
        spec = self._should_fire(site)
        if spec is not None:
            raise exc(f"{spec.message} [site={site} "
                      f"fire={self.fire_count(site)}]")

    def perturb(self, site: str, arr: np.ndarray) -> np.ndarray:
        """Deterministic additive perturbation (per-thread seeded rng,
        call-order reproducible) when the site is armed; identity
        otherwise."""
        spec = self._should_fire(site)
        if spec is None:
            return arr
        return arr + spec.scale * self._stream().rng.standard_normal(
            arr.shape)


# -------------------------------------------------- process-global hooks

# Registered with the static concurrency checker: rebinding the active
# injector must hold _ACTIVE_LOCK; thread-scoped activations live on
# _SCOPED and never race.
SHARED_MUTABLE = ("_ACTIVE",)

_ACTIVE: Optional[FaultInjector] = None
_ACTIVE_LOCK = threading.Lock()
_SCOPED = threading.local()      # .stack: per-thread activation stack


def get() -> Optional[FaultInjector]:
    """The effective injector for the calling thread: innermost
    thread-scoped activation first, then the process-global one."""
    stack = getattr(_SCOPED, "stack", None)
    if stack:
        return stack[-1]
    return _ACTIVE


def activate(inj: Optional[FaultInjector]) -> Optional[FaultInjector]:
    global _ACTIVE
    with _ACTIVE_LOCK:
        prev, _ACTIVE = _ACTIVE, inj
    return prev


@contextlib.contextmanager
def injected(seed: int = 0,
             arms: Optional[Dict[str, dict]] = None,
             scope: str = "process") -> Iterator[FaultInjector]:
    """``with faults.injected(seed=7, arms={faults.BINV: {...}}) as inj``
    — installs a fresh injector for the block, restoring the previous
    one on exit.  Reentrant: nested blocks stack and unwind correctly.
    ``scope="thread"`` confines the activation to the calling thread
    (other threads keep seeing the process-global injector, if any).
    """
    if scope not in ("process", "thread"):
        raise ValueError(f"scope must be 'process' or 'thread', "
                         f"got {scope!r}")
    inj = FaultInjector(seed)
    for site, kw in (arms or {}).items():
        inj.arm(site, **kw)
    if scope == "thread":
        stack = getattr(_SCOPED, "stack", None)
        if stack is None:
            stack = _SCOPED.stack = []
        stack.append(inj)
        try:
            yield inj
        finally:
            stack.pop()
    else:
        prev = activate(inj)
        try:
            yield inj
        finally:
            activate(prev)


def maybe_raise(site: str, exc=OSError) -> None:
    """Production-side hook: no-op unless an injector is active."""
    inj = get()
    if inj is not None:
        inj.maybe_raise(site, exc)


def perturb(site: str, arr: np.ndarray) -> np.ndarray:
    inj = get()
    if inj is None:
        return arr
    return inj.perturb(site, arr)


def fire_count(site: str) -> int:
    inj = get()
    return 0 if inj is None else inj.fire_count(site)


# ----------------------------------------------------------- test double


class FlakySource:
    """ChunkSource wrapper raising transient ``OSError`` on chosen chunk
    indices for their first ``fail_times`` read attempts — the
    deterministic stand-in for a flaky disk/network read.  Duck-types the
    ``core.bucketing.ChunkSource`` protocol so it wraps any source.
    """

    def __init__(self, inner, *, fail_chunks=(1,), fail_times: int = 2,
                 exc=OSError):
        self.inner = inner
        self.fail_chunks = set(int(i) for i in fail_chunks)
        self.fail_times = int(fail_times)
        self.exc = exc
        self.attempts: Dict[int, int] = {}
        self.raised = 0

    def chunks(self, chunk_rows: int):
        for i, chunk in enumerate(self.inner.chunks(chunk_rows)):
            if i in self.fail_chunks:
                k = self.attempts.get(i, 0)
                if k < self.fail_times:
                    self.attempts[i] = k + 1
                    self.raised += 1
                    raise self.exc(f"flaky chunk {i} (attempt {k + 1})")
            yield chunk

    @property
    def num_rows(self) -> int:
        return self.inner.num_rows

    @property
    def num_cols(self) -> int:
        return self.inner.num_cols
