"""Cross-query partition cache (port of ``repro.core.qcache``).

Progressive Shading re-descends the same hierarchy and re-prices the same
groups for every query, yet real workloads are flights of overlapping
variants: the same query re-run, a bound tightened, a constraint widened.
This module caches the per-query artifacts that survive one
``engine.solve`` and lets the next query reuse them:

* **per-group candidate-id sets** -- each layer's candidate set, stored
  split by its parent group id (``hier.layers[l].part.gid``), so a leaf-
  local ``Hierarchy.append`` invalidates exactly the touched groups (and
  their ancestors) instead of the whole entry;
* **group LP objective bounds** -- the layer/Dual-Reducer LP objective at
  store time, consulted on reuse as a staleness check (a cached prune
  whose LP bound no longer reproduces is abandoned, never trusted);
* **final layer bases** -- each layer LP's final basis/bound state and
  Dual Reducer's lp1 basis, so a reusing query warm-starts its cascade
  LPs (directly when the candidate columns match, via
  ``shading.map_warm_basis`` otherwise) instead of cold-starting.

Keying: ``(hierarchy fingerprint, canonical query signature)`` at the
entry level, ``(layer, group id)`` inside the entry.  Signatures come
from :meth:`repro_torch.core.paql.PackageQuery.signature`: constraint
order is normalized away, and ``sig_a.contained_in(sig_b)`` is a sound
test that a's constraint region lies inside b's, which drives the
subsumption path: a query contained in a cached signature starts from
the cached layer-0 candidate set (the pre-prune) instead of descending
the full hierarchy.

Everything here is host numpy, as in the reference; the solves that a
hit shortcuts to (Dual Reducer, its batched LP flights) run on the
engine's device.

Correctness contract (what a consumer may rely on):

* a cache hit can only *shortcut* the descent, never change the answer
  class: every reused package is re-validated against the relation
  (``check_package``) and every reused candidate set is re-solved by the
  ordinary guarded Dual Reducer, whose LP bound must reproduce the
  cached bound (exact hits) or respect containment monotonicity
  (subsumption hits).  Any mismatch -- including an invalidated group,
  an evicted basis, or an infeasible pruned solve -- falls back to the
  cold descent and records a ``cache_fallback`` rung in the
  ``SolveReport``; quality is never silently degraded.
* ``Hierarchy.append`` invalidates the touched leaves' group entries and
  their ancestors through the invalidation hook installed by
  :meth:`QCache.register`; an entry that lost any group is incomplete
  and never serves hits again (it is re-populated by the next cold
  solve).
* memory is bounded: entries are LRU-evicted by artifact bytes against
  ``max_bytes``, with eviction counts surfaced in :class:`CacheStats`.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.runtime import racecheck

# Default artifact budget: candidate-id sets dominate; 64 MiB holds
# ~2000 distinct alpha=100k query entries' worth of int64 ids.
DEFAULT_MAX_BYTES = 64 << 20

_ENTRY_OVERHEAD = 256       # rough per-group dict/bookkeeping bytes


@dataclasses.dataclass
class CacheStats:
    """Counters for one :class:`QCache` (cumulative across queries)."""
    hits: int = 0
    exact_hits: int = 0
    contained_hits: int = 0
    misses: int = 0
    stale_misses: int = 0       # entry matched but had invalidated groups
    fallbacks: int = 0          # hits abandoned by validation -> cold path
    stores: int = 0
    evictions: int = 0
    invalidated_groups: int = 0
    bytes: int = 0

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CacheEntry:
    """Artifacts of one solved query over one hierarchy."""
    sig: object                     # paql.QuerySignature
    fingerprint: str
    # layer l (1..L) -> {parent gid at layer l -> candidate ids at l-1}
    cands: Dict[int, Dict[int, np.ndarray]]
    expected: Dict[int, int]        # layer -> group count at store time
    # layer l -> (S_used, basis, at_upper, obj_minform) of the layer-l LP
    layer_warms: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray, float]]
    dr_warm: Optional[Tuple[np.ndarray, np.ndarray]]   # lp1 basis/at_upper
    lp_bound: float                 # Dual Reducer lp1 bound (query sense)
    package_idx: Optional[np.ndarray] = None
    package_mult: Optional[np.ndarray] = None
    package_obj: float = 0.0
    complete: bool = True
    nbytes: int = 0

    def layer_complete(self, l: int) -> bool:
        return len(self.cands.get(l, {})) == self.expected.get(l, -1)

    def group_ids(self, l: int):
        """Sorted group ids still cached at layer ``l`` (test/debug API)."""
        return sorted(self.cands.get(l, {}).keys())

    def candidates(self, l: int) -> Optional[np.ndarray]:
        """The layer-(l-1) candidate set, reassembled from its per-group
        pieces — None once any of the layer's groups was invalidated."""
        if not self.layer_complete(l):
            return None
        parts = list(self.cands[l].values())
        if not parts:
            return np.zeros(0, np.int64)
        return np.sort(np.concatenate(parts))

    def dr_warm_start(self):
        from repro_torch.core.lp import WarmStart
        if self.dr_warm is None:
            return None
        basis, at_upper = self.dr_warm
        return WarmStart(basis.copy(), at_upper.copy())

    def measure(self) -> int:
        total = 0
        for d in self.cands.values():
            for arr in d.values():
                total += arr.nbytes + _ENTRY_OVERHEAD
        for (S, basis, au, _obj) in self.layer_warms.values():
            total += S.nbytes + basis.nbytes + au.nbytes
        if self.dr_warm is not None:
            total += self.dr_warm[0].nbytes + self.dr_warm[1].nbytes
        if self.package_idx is not None:
            total += self.package_idx.nbytes + self.package_mult.nbytes
        return total + _ENTRY_OVERHEAD


@dataclasses.dataclass
class CacheHit:
    """One successful lookup: the entry plus how the signature matched."""
    entry: CacheEntry
    exact: bool

    @property
    def kind(self) -> str:
        return "exact" if self.exact else "contained"

    def warm_for_layer0(self, hier, query, S0: np.ndarray):
        """Warm start for Dual Reducer's lp1 over ``S0``.

        Prefers the cached lp1 final basis (identical columns on the
        shortcut path); falls back to re-mapping the cached layer-1
        basis down onto ``S0`` via :func:`shading.map_warm_basis` when
        the lp1 basis is gone (e.g. stored before an eviction trim).
        """
        ws = self.entry.dr_warm_start()
        if ws is not None:
            return ws
        state = self.entry.layer_warms.get(1)
        if state is None:
            return None
        from repro_torch.core.shading import map_warm_basis
        S_used, basis, at_upper, _obj = state
        pseudo = SimpleNamespace(basis=basis, at_upper=at_upper,
                                 y=np.zeros(query.m))
        return map_warm_basis(hier, 1, S_used, pseudo, S0,
                              obj_attr=query.objective_attr)


class QCache:
    """Cross-query artifact cache over one or more hierarchies.

    One instance may serve many engines/hierarchies (the serving-layer
    shape): entries are keyed by hierarchy fingerprint, and
    :meth:`register` installs the append-invalidation hook per
    hierarchy.  ``reuse_packages=False`` disables the exact-hit package
    fast path (every hit then re-solves Dual Reducer over the cached
    candidate set — the pure artifact-reuse mode).

    Concurrency: every structure (entries, stats, registration set, the
    in-flight populate claims) is guarded by one reentrant instrumented
    lock, so concurrent sessions share the cache safely, and the lock
    counts its contention and hold time (:meth:`lock_stats`).  Cold
    solves are NEVER run under the lock (a descent is seconds long);
    instead :meth:`begin_populate` claims a
    key with an in-flight event, the owner solves outside the lock and
    :meth:`store`s, and concurrent same-key sessions
    :meth:`wait_populate` then re-probe — the atomic get-or-populate
    protocol (:meth:`get_or_populate` packages it).
    """

    __guarded_by__ = {"_entries": "_lock", "stats": "_lock",
                      "_registered": "_lock", "_inflight": "_lock"}

    def __init__(self, max_bytes: int = DEFAULT_MAX_BYTES, *,
                 reuse_packages: bool = True,
                 gap_accept: float = 0.01):
        self.max_bytes = int(max_bytes)
        self.reuse_packages = bool(reuse_packages)
        # contained-hit quality gate: a pruned solve whose integrality
        # gap (ILP obj vs its own LP bound) exceeds this relative
        # threshold is abandoned for the cold descent — the prune lost
        # support the tightened query needed
        self.gap_accept = float(gap_accept)
        self.stats = CacheStats()
        self._entries: "OrderedDict[tuple, CacheEntry]" = OrderedDict()
        self._registered: set = set()
        self._lock = racecheck.InstrumentedRLock("qcache")
        self._inflight: Dict[tuple, threading.Event] = {}

    # ------------------------------------------------------------ admin
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def entries(self):
        """(fingerprint, signature, entry) triples (test/debug API)."""
        with self._lock:
            return [(fp, sig, e) for (fp, sig), e in self._entries.items()]

    def register(self, hier) -> str:
        """Bind a hierarchy: returns its fingerprint and installs the
        append-invalidation hook (idempotent per hierarchy object).

        The hook install happens under the cache lock; ``Hierarchy``
        keeps no lock of its own, so QCache._lock stays a leaf in the
        lock order."""
        with self._lock:
            if id(hier) not in self._registered:
                hier.add_invalidation_hook(self._on_append)
                self._registered.add(id(hier))
        return hier.fingerprint

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.stats.bytes = 0

    def stats_snapshot(self) -> CacheStats:
        """Atomic copy of the counters — never torn mid-update."""
        with self._lock:
            return dataclasses.replace(self.stats)

    def note_fallback(self) -> None:
        """A hit was abandoned by validation (cold path taken)."""
        with self._lock:
            self.stats.fallbacks += 1

    def lock_stats(self) -> dict:
        """Contention/hold-time counters of the cache lock."""
        return self._lock.stats()

    # ----------------------------------------------------------- lookup
    def lookup(self, fingerprint: str, sig) -> Optional[CacheHit]:
        """Exact-signature hit, else the tightest complete superset
        (subsumption): among cached signatures that contain ``sig``,
        the one with the fewest layer-0 candidates wins."""
        racecheck.checkpoint("qcache.lookup")
        with self._lock:
            return self._lookup_locked(fingerprint, sig)

    @racecheck.guarded_by("_lock")
    def _lookup_locked(self, fingerprint: str, sig) -> Optional[CacheHit]:
        key = (fingerprint, sig)
        entry = self._entries.get(key)
        if entry is not None:
            if entry.complete:
                self._entries.move_to_end(key)
                self.stats.hits += 1
                self.stats.exact_hits += 1
                return CacheHit(entry, exact=True)
            self.stats.misses += 1
            self.stats.stale_misses += 1
            return None
        best = best_key = None
        for (fp, cached_sig), e in self._entries.items():
            if fp != fingerprint or not e.complete:
                continue
            if not sig.contained_in(cached_sig):
                continue
            size = sum(len(a) for a in e.cands.get(1, {}).values())
            if best is None or size < best[0]:
                best, best_key = (size, e), (fp, cached_sig)
        if best is None:
            self.stats.misses += 1
            return None
        self._entries.move_to_end(best_key)
        self.stats.hits += 1
        self.stats.contained_hits += 1
        return CacheHit(best[1], exact=False)

    # ------------------------------------------------- populate protocol
    def begin_populate(self, fingerprint: str, sig) -> bool:
        """Claim the cold solve for ``(fingerprint, sig)``.  True means
        the caller owns the populate and MUST call :meth:`end_populate`
        (a ``finally`` obligation); False means another session is
        already solving the same key — :meth:`wait_populate` for it."""
        key = (fingerprint, sig)
        with self._lock:
            if key in self._inflight:
                return False
            self._inflight[key] = threading.Event()
            return True

    def end_populate(self, fingerprint: str, sig) -> None:
        """Release the claim and wake waiters (store or not — a failed
        solve releases too, and waiters re-probe and miss)."""
        with self._lock:
            ev = self._inflight.pop((fingerprint, sig), None)
        if ev is not None:
            ev.set()

    def wait_populate(self, fingerprint: str, sig,
                      timeout: Optional[float] = None) -> bool:
        """Block until an in-flight populate of the key (if any)
        finishes; True unless the timeout expired first."""
        with self._lock:
            ev = self._inflight.get((fingerprint, sig))
        if ev is None:
            return True
        return racecheck.wait_event(ev, "qcache.wait_populate", timeout)

    def get_or_populate(self, fingerprint: str, sig, solve):
        """Atomic get-or-populate: returns ``("hit", CacheHit)`` or
        ``("solved", solve())``.  Exactly one caller runs ``solve()``
        per cold key; concurrent same-key callers wait and take the
        hit.  ``solve`` runs OUTSIDE the lock and is expected to
        :meth:`store` before returning (a non-storing solve is legal —
        waiters then re-probe, miss, and one of them solves next)."""
        key = (fingerprint, sig)
        while True:
            racecheck.checkpoint("qcache.get_or_populate")
            owner_ev = None
            with self._lock:
                hit = self._lookup_locked(fingerprint, sig)
                if hit is not None:
                    return "hit", hit
                ev = self._inflight.get(key)
                if ev is None:
                    owner_ev = self._inflight[key] = threading.Event()
            if owner_ev is not None:
                break
            racecheck.wait_event(ev, "qcache.wait_inflight")
        try:
            value = solve()
        finally:
            with self._lock:
                self._inflight.pop(key, None)
            owner_ev.set()
        return "solved", value

    # ------------------------------------------------------------ store
    def store(self, fingerprint: str, sig, *, hier,
              cands: Dict[int, np.ndarray],
              layer_warms: Dict[int, tuple],
              dr_warm, lp_bound: float,
              package: Optional[tuple] = None) -> CacheEntry:
        """Populate after a clean cold solve.

        ``cands[l]`` is the layer-(l-1) candidate set the cascade used
        (l = 1..L); it is split per parent group here so invalidation
        can be leaf-local.  ``layer_warms[l]`` is the layer-l LP state
        ``(S_used, basis, at_upper, obj)``; ``dr_warm`` the lp1
        basis/at_upper pair (or None); ``package`` the validated final
        ``(idx, mult, obj)``.

        The numpy grouping/copy work runs outside the lock; only the
        insert + eviction mutate shared state.
        """
        grouped: Dict[int, Dict[int, np.ndarray]] = {}
        expected: Dict[int, int] = {}
        for l, ids in cands.items():
            ids = np.asarray(ids, np.int64)
            gid = np.asarray(hier.layers[l].part.gid[ids], np.int64)
            order = np.argsort(gid, kind="stable")
            gs, starts = np.unique(gid[order], return_index=True)
            bounds = np.append(starts, len(ids))
            grouped[l] = {int(g): np.ascontiguousarray(
                ids[order[bounds[i]:bounds[i + 1]]])
                for i, g in enumerate(gs)}
            expected[l] = len(gs)
        warms = {int(l): (np.asarray(S, np.int64).copy(),
                          np.asarray(b, np.int64).copy(),
                          np.asarray(a, bool).copy(), float(o))
                 for l, (S, b, a, o) in layer_warms.items()}
        dw = None
        if dr_warm is not None:
            dw = (np.asarray(dr_warm.basis, np.int64).copy(),
                  np.asarray(dr_warm.at_upper, bool).copy()
                  if dr_warm.at_upper is not None
                  else np.zeros(0, bool))
        entry = CacheEntry(sig=sig, fingerprint=fingerprint, cands=grouped,
                           expected=expected, layer_warms=warms,
                           dr_warm=dw, lp_bound=float(lp_bound))
        if package is not None:
            idx, mult, obj = package
            entry.package_idx = np.asarray(idx, np.int64).copy()
            entry.package_mult = np.asarray(mult, np.float64).copy()
            entry.package_obj = float(obj)
        entry.nbytes = entry.measure()
        key = (fingerprint, sig)
        racecheck.checkpoint("qcache.store")
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.stats.bytes -= old.nbytes
            self._entries[key] = entry
            self.stats.bytes += entry.nbytes
            self.stats.stores += 1
            self._evict(keep=key)
        return entry

    @racecheck.guarded_by("_lock")
    def _evict(self, keep: tuple) -> None:
        """LRU-evict by artifact bytes until under budget (the entry
        just stored survives even if alone over budget — a cache that
        cannot hold one entry would silently disable itself)."""
        while self.stats.bytes > self.max_bytes and len(self._entries) > 1:
            key = next(iter(self._entries))
            if key == keep:
                break
            entry = self._entries.pop(key)
            self.stats.bytes -= entry.nbytes
            self.stats.evictions += 1

    # ----------------------------------------------------- invalidation
    def _on_append(self, hier, touched_leaves: np.ndarray) -> None:
        """Hierarchy.append hook: drop the touched leaves' group entries
        and their ancestors at every layer, for every entry of this
        hierarchy.  Entries that lost any group stop serving hits."""
        fp = hier.fingerprint
        ancestors = hier.leaf_ancestors(touched_leaves)
        with self._lock:
            for (efp, _sig), entry in self._entries.items():
                if efp != fp:
                    continue
                for l, gids in ancestors.items():
                    d = entry.cands.get(l)
                    if not d:
                        continue
                    for g in gids:
                        arr = d.pop(int(g), None)
                        if arr is not None:
                            removed = arr.nbytes + _ENTRY_OVERHEAD
                            entry.nbytes -= removed
                            self.stats.bytes -= removed
                            self.stats.invalidated_groups += 1
                            entry.complete = False
