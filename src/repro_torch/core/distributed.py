"""Distributed pricing backend (port of ``repro.core.distributed``) --
so far only its :class:`BoundedStepCache`.

The batched bound-variant LP engine (``core.lp_batch``) keeps one launch
workspace per shape class in a ``BoundedStepCache``, as the reference
keeps one compiled executable per class in it.  The rest of the module
(``make_pq_step``, ``make_update_step``, ``make_refresh_step``,
``solve_lp_dist`` on ``torch.distributed``) is ROADMAP queue 1, item 6.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict

from repro_torch.runtime import racecheck

STEP_CACHE_MAXSIZE = 64   # distinct shape classes kept


class BoundedStepCache:
    """LRU cache of per-shape-class objects (the reference's jitted step
    triples and compiled batched cores; here the batched LP engine's
    launch workspaces).

    Replaces a bare ``functools.lru_cache``: same bound, but with
    explicit hit/miss/eviction counters (per-class churn is a real
    cost — an eviction storm means shapes are cycling faster than the
    cache can hold and should be visible, not silent).

    Thread-safe: entries and counters are guarded by ``_lock``, and each
    resolved ``get_or_create`` is exactly one hit or one miss, so
    ``hits + misses == lookups`` always holds.  A cold key is built by
    exactly one thread — the first caller claims the key with an
    in-flight event and runs ``factory()`` *outside* the lock (a build
    may be slow -- the reference traces a jit there, the port allocates
    device buffers; holding the lock would serialize every other shape
    class behind it), while later callers wait on the event and
    re-probe.
    """

    __guarded_by__ = {"_entries": "_lock", "hits": "_lock",
                      "misses": "_lock", "evictions": "_lock",
                      "lookups": "_lock", "_building": "_lock"}

    def __init__(self, maxsize: int = STEP_CACHE_MAXSIZE):
        self.maxsize = int(maxsize)
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.lookups = 0
        self._lock = threading.Lock()
        self._building: Dict[tuple, threading.Event] = {}

    # The probe and the insert live in different lock scopes by design:
    # the in-flight event in ``_building`` is the claim token that makes
    # the check-then-act atomic (waiters re-probe after the owner
    # publishes), so the REPRO009 shape here is the sanctioned pattern.
    # repro: allow[REPRO009] claim-token get-or-create: _building event
    # serializes builders; waiters re-probe after the owner's insert
    def get_or_create(self, key: tuple, factory):
        while True:
            racecheck.checkpoint("step_cache.probe")
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    self.lookups += 1
                    return entry
                ev = self._building.get(key)
                if ev is None:
                    # We own the build for this key.
                    ev = self._building[key] = threading.Event()
                    self.misses += 1
                    self.lookups += 1
                    break
            # Another thread is building this key: wait, then re-probe.
            # Unresolved probes are not charged, so each resolved call is
            # exactly one lookup and one of hit/miss.
            racecheck.wait_event(ev, "step_cache.wait")
        try:
            entry = factory()
        # repro: allow[REPRO004] claim-release path: the failure is
        # RE-RAISED after waking waiters (nothing is swallowed) — not
        # releasing the claim would park every waiter forever
        except BaseException:
            with self._lock:
                self._building.pop(key, None)
            ev.set()
            raise
        racecheck.checkpoint("step_cache.publish")
        with self._lock:
            self._entries[key] = entry
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                self.evictions += 1
            self._building.pop(key, None)
        ev.set()
        return entry

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        """Atomic snapshot — never torn: hits+misses == lookups."""
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "lookups": self.lookups,
                    "size": len(self._entries), "maxsize": self.maxsize}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
