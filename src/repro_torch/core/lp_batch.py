"""Batched bound-variant LP engine — one launch for a whole flight (port of
``repro.core.lp_batch``).

Branch & bound, the Dual Reducer's auxiliary re-solves and the shading
ladder's retry rungs all generate *flights* of LPs that share one
``(c, A)`` and differ only in variable bounds (branching pins
``lb_j = ub_j = v``, aux rungs shrink ``ub``, ladder lanes mask columns
out by ``ub = 0``).  Solved one at a time through ``solve_lp_np`` each
tiny LP pays full Python overhead per *pivot*; here the whole flight is
ONE launch of ``csrc/lp_batch.cu`` on ``device=`` (one CTA per lane, see
``repro_torch.kernels.lp_batch``), or its plain torch version on
``device="cpu"``.

Design points (the reference's, see its ``docs/BATCHING.md``):

* **Shape classes** — m pads to a pow2, n and K to multiples of 16 and 4;
  one launch workspace per class (``LaneSolver``: device and pinned
  buffers, made once, used by one dispatch at a time) in a
  ``BoundedStepCache`` with hit/miss/eviction counters, so K = 6, 7 and 8
  share one workspace as they share one executable in the reference.  Padding is inert by construction: padded
  columns have ``c = 0``, a zero A-column and ``l = u = 0`` (never
  eligible to enter); padded rows are zero with ``l = u = 0`` slacks
  (never violated, their slack never leaves the basis) — the padded
  solve is the unpadded solve embedded, pivot for pivot.
* **Lanes** — each lane runs to its own end; the shared pivot budget is
  imposed as the reference's lockstep loop imposes it (``spent`` =
  active lanes per trip), by at most one more launch with a trip limit.
* **Warm starts** — per-lane bases with the single twins' validation
  semantics, validated on the host for all lanes at once (numpy) and
  rejected-to-cold per lane, surfaced via ``warm_start_rejected`` notes.
* **Sequential path** — for K <= 2 (``backend="auto"``: a launch's fixed
  cost exceeds two warm host solves, the reference's rule) or on request
  (``backend="np"``) the engine runs the sequential ``solve_lp_np`` loop
  with identical per-call budget charging — bit-compatible with today's
  callers.

Budget contract: the shared pivot budget is charged as the SUM of
per-lane pivots through ``guard.SolveBudget`` (one ``charge_pivots`` per
dispatch on the batched path; per call on the numpy path).
"""
from __future__ import annotations

import threading
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.distributed import BoundedStepCache
from repro_torch.core.guard import NumericalMonitor, SolveBudget
from repro_torch.core.lp import (BUDGET, INFEASIBLE, ITER_LIMIT, LPResult,
                                 REFACTOR_EVERY, _unpack_warm, row_scaling,
                                 solve_lp_np)
from repro_torch.device import resolve_device
from repro_torch.kernels.lp_batch import LaneSolver, in_width

_M_FLOOR = 4        # smallest row shape class
_CACHE_MAXSIZE = 32  # distinct (m, n, K, cap) classes kept

_K_STEP = 4         # lane-count shape classes are multiples of this
# structural columns round up to a multiple of this, not to a power of
# two: pow2 rounding (n = 150 -> 256) would make every lane walk padded
# columns.  A run touches only a handful of distinct n, so the class
# count stays bounded (and LRU-evicted) anyway
_N_STEP = 16

# ``backend="auto"`` crossover, the reference's: flights at or below this
# width run the sequential numpy loop
_AUTO_NP_MAX = 2

_COMPILE_CACHE = BoundedStepCache(maxsize=_CACHE_MAXSIZE)

# dispatch accounting (benches record these to show the shape-class
# policy holds: bounded classes, one launch per flight)
_STATS = {"dispatches": 0, "instances": 0, "np_fallbacks": 0,
          "batched_pivots": 0, "prep_hits": 0, "prep_misses": 0}

_STATS_LOCK = threading.Lock()
_PREP_LOCK = threading.Lock()

# Mutations of these module globals must hold the matching lock (_STATS
# under _STATS_LOCK, _PREPPED under _PREP_LOCK, _COMPILE_CACHE's entries
# under the cache's own lock).  Each cached LaneSolver's packs and
# workspace are shared by every dispatch of its class: a call holds the
# solver's ``_lock`` from the copy in to the copy out.  Lock order:
# _PREP_LOCK may take _STATS_LOCK; never the reverse; a solver's lock is
# taken with no other lock held.
SHARED_MUTABLE = ("_STATS", "_PREPPED", "_COMPILE_CACHE")


def batch_cache_stats() -> dict:
    """Counters of the shape-class workspace cache (observability API)."""
    return _COMPILE_CACHE.stats()


def batch_stats() -> dict:
    """Dispatch counters of the batched engine (atomic snapshot)."""
    with _STATS_LOCK:
        return dict(_STATS)


def reset_batch_stats() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


def _pow2(v: int, floor: int) -> int:
    return max(floor, 1 << max(int(v) - 1, 0).bit_length())


def _lane_solver(m_pad: int, n_pad: int, K_pad: int, max_iters: int,
                 refactor_every: int, device: torch.device) -> LaneSolver:
    """The launch workspace of one (m, n, K, cap) class on ``device``."""
    key = (m_pad, n_pad, K_pad, max_iters, refactor_every, str(device))
    return _COMPILE_CACHE.get_or_create(
        key, lambda: LaneSolver(m_pad, n_pad, K_pad, max_iters,
                                refactor_every, device))


_PREP_MAX = 8        # prepared shared-(c, A) standard forms kept resident
_PREPPED: List[dict] = []


def _prep_shared(c, A_t, bl, bu, m_pad: int, n_pad: int,
                 device: torch.device) -> dict:
    """Build (or reuse) the padded shared standard form and its tensors on
    ``device``.  A B&B wave loop re-dispatches the SAME (c, A, bl, bu)
    every wave, so prepared forms are cached by content (a memcmp-style
    compare, so in-place caller mutations are safe) and bounded FIFO.

    ``_PREP_LOCK`` is held for the whole scan-build-insert, so the
    check-then-act is one atomic scope and concurrent waves share one
    prepared form."""
    with _PREP_LOCK:
        for e in _PREPPED:
            if (e["m_pad"] == m_pad and e["n_pad"] == n_pad
                    and e["device"] == device
                    and e["c"].shape == c.shape
                    and e["A_t"].shape == A_t.shape
                    and np.array_equal(e["c"], c)
                    and np.array_equal(e["A_t"], A_t)
                    and np.array_equal(e["bl"], bl)
                    and np.array_equal(e["bu"], bu)):
                with _STATS_LOCK:
                    _STATS["prep_hits"] += 1
                return e
        with _STATS_LOCK:
            _STATS["prep_misses"] += 1
        m, n = A_t.shape
        N_pad = n_pad + m_pad
        scale = row_scaling(A_t)
        cf = np.zeros(N_pad)
        cf[:n] = c
        A = np.zeros((m_pad, N_pad))
        A[:m, :n] = -(A_t * scale[:, None])
        A[:, n_pad:] = np.eye(m_pad)
        e = {"c": c.copy(), "A_t": A_t.copy(), "bl": bl.copy(),
             "bu": bu.copy(), "m_pad": m_pad, "n_pad": n_pad,
             "device": device, "scale": scale, "cf": cf, "A": A,
             "bls": bl * scale, "bus": bu * scale,
             "cf_dev": torch.as_tensor(cf, device=device),
             "A_dev": torch.as_tensor(A, device=device)}
        _PREPPED.append(e)
        if len(_PREPPED) > _PREP_MAX:
            _PREPPED.pop(0)
        return e


def _validate_warm_batch(A, cf, l_rows, u_rows, tol_rows, WB, HT):
    """Vectorized per-lane warm-basis validation — the same acceptance
    rules as ``lp._warm_state``, applied to all W candidate bases at
    once (one batched inverse instead of W host factorizations).

    Returns ``(ok, at_up, reasons)``: accept mask (W,), the derived
    bound patterns (W, N) for accepted lanes, and a rejection reason
    per lane (None when accepted)."""
    W, m = WB.shape
    N = A.shape[1]
    ok = np.ones(W, bool)
    reasons: List[Optional[str]] = [None] * W
    at_up = np.zeros((W, N), bool)
    srt = np.sort(WB, axis=1)
    bad_idx = (WB.min(axis=1) < 0) | (WB.max(axis=1) >= N) | \
        np.any(srt[:, 1:] == srt[:, :-1], axis=1)
    for i in np.flatnonzero(bad_idx):
        ok[i] = False
        reasons[i] = "basis indices out of range or duplicated"
    good = np.flatnonzero(ok)
    if not good.size:
        return ok, at_up, reasons
    WBg = WB[good]
    B = np.transpose(A[:, WBg], (1, 0, 2))        # (G, m, m)
    try:
        Binv = np.linalg.inv(B)
    except np.linalg.LinAlgError:
        Binv = np.full_like(B, np.inf)
        for gi in range(len(B)):
            try:
                Binv[gi] = np.linalg.inv(B[gi])
            except np.linalg.LinAlgError:
                reasons[good[gi]] = "singular basis"
    with np.errstate(invalid="ignore"):
        illcond = ~np.all(np.isfinite(Binv), axis=(1, 2)) | \
            (np.max(np.abs(np.where(np.isfinite(Binv), Binv, np.inf)),
                    axis=(1, 2)) > 1e12)
    cB = cf[WBg]                                   # (G, m)
    y = (np.transpose(Binv, (0, 2, 1)) @ cB[..., None])[..., 0]
    d = cf[None, :] - y @ A                        # (G, N)
    np.put_along_axis(d, WBg, 0.0, axis=1)
    IB = np.zeros((len(good), N), bool)
    np.put_along_axis(IB, WBg, True, axis=1)
    tg = tol_rows[good][:, None]
    Lg, Ug = l_rows[good], u_rows[good]
    au = np.where(d < -tg, True, np.where(d > tg, False, HT[good]))
    inf_l = np.isinf(Lg)
    inf_u = np.isinf(Ug)
    if inf_l.any() or inf_u.any():
        au |= inf_l
        au &= ~inf_u
        bad_dual = np.any((~IB) & (((d < -tg) & inf_u)
                                   | ((d > tg) & inf_l)
                                   | (inf_l & inf_u)), axis=1)
    else:
        # all-finite bounds (every B&B / aux-rung / ladder flight): no
        # pinned-at-infinity patterns exist, skip their (G, N) passes
        bad_dual = np.zeros(len(good), bool)
    au[IB] = False
    for gi, i in enumerate(good):
        if reasons[i] is not None:                 # singular (fallback)
            ok[i] = False
        elif illcond[gi]:
            ok[i] = False
            reasons[i] = "ill-conditioned basis"
        elif bad_dual[gi]:
            ok[i] = False
            reasons[i] = \
                "dual-infeasible column pinned at an infinite bound"
        else:
            at_up[i] = au[gi]
    return ok, at_up, reasons


def _as_bound_arr(batch, K: int, n: int, default: float,
                  name: str) -> np.ndarray:
    """Normalize ub_batch / lb_batch into one (K, n) float64 array."""
    if batch is None:
        return np.full((K, n), default)
    try:
        # fast path: uniform (n,) rows stack in one numpy call (the B&B
        # wave always lands here — per-lane python only on odd payloads)
        arr = np.asarray(batch, np.float64)
        if arr.shape == (K, n):
            return arr
    except (ValueError, TypeError):
        pass
    rows = []
    for k in range(K):
        b = batch[k]
        if b is None:
            rows.append(np.full(n, default))
            continue
        b = np.asarray(b, np.float64).ravel()
        if b.shape != (n,):
            raise ValueError(f"{name}[{k}] shape {b.shape} != ({n},)")
        rows.append(b)
    return np.stack(rows)


def _infeasible_result(n: int, m: int, note: Optional[str] = None,
                       status: int = INFEASIBLE) -> LPResult:
    return LPResult(status, np.zeros(n), 0.0, 0, np.arange(n, n + m),
                    np.zeros(n + m, bool), np.zeros(m),
                    notes=() if note is None else (note,))


class _Lane(NamedTuple):
    """One lane's unpacked answer (original column space, duals in the
    caller's units) and the notes the host added before the launch."""
    status: int
    x: np.ndarray
    obj: float
    iters: int
    basis: np.ndarray
    at_upper: np.ndarray
    y: np.ndarray
    n_bland: int
    n_drift: int
    notes_pre: List[str]

    def notes(self) -> List[str]:
        notes = list(self.notes_pre)
        if self.n_bland:
            notes.append(f"stall: Bland's rule for {self.n_bland} pivots")
        if self.n_drift:
            notes.append(f"drift: {self.n_drift} forced refactorizations")
        return notes

    def result(self, status: int, notes: List[str]) -> LPResult:
        return LPResult(status, self.x, self.obj, self.iters, self.basis,
                        self.at_upper, self.y, notes=tuple(notes))


def _dispatch(c, A_t, bl, bu, ub_arr, lb_arr, tol_arr, warm_list, *,
              cap: int, pivot_cap: Optional[int], refactor_every: int,
              device: torch.device):
    """One batched solve of K lanes: pad to the shape class, assemble the
    in pack (warm bases validated on the host), one launch (two under a
    binding ``pivot_cap``; ``None`` = K * cap), unpack and un-pad.

    Returns ``(results, lanes, spent)``: ``results[k]`` is an LPResult
    for lanes decided on the host (box-infeasible), else None;
    ``lanes[k]`` a ``_Lane`` for the others; ``spent`` the lanes'
    pivots."""
    K = len(ub_arr)
    m, n = A_t.shape
    # m rounds up to pow2 (rows are tiny); n and K round up to multiples
    # of _N_STEP / _K_STEP.  Class count stays bounded: K <= 2*wave_width
    # gives at most 2W/_K_STEP classes per geometry
    m_pad = _pow2(m, _M_FLOOR)
    n_pad = -(-n // _N_STEP) * _N_STEP
    K_pad = -(-K // _K_STEP) * _K_STEP
    N_pad = n_pad + m_pad
    shared = _prep_shared(c, A_t, np.asarray(bl, np.float64),
                          np.asarray(bu, np.float64), m_pad, n_pad, device)
    cf, A = shared["cf"], shared["A"]
    bls, bus, scale = shared["bls"], shared["bus"], shared["scale"]
    notes_pre: List[List[str]] = [[] for _ in range(K)]

    # ---- vectorized lane assembly: ALL per-lane operands in ONE f64
    # array (layout in kernels.lp_batch; views below alias in_pack)
    in_pack = np.zeros((K_pad, in_width(N_pad, m_pad)))
    l_b = in_pack[:, :N_pad]
    u_b = in_pack[:, N_pad:2 * N_pad]
    basis0_b = in_pack[:, 2 * N_pad + 1:2 * N_pad + 1 + m_pad]
    at_upper0_b = in_pack[:, 2 * N_pad + 1 + m_pad:
                          3 * N_pad + 1 + m_pad]
    valid_b = in_pack[:, 3 * N_pad + 1 + m_pad]
    l_b[:K, :n] = lb_arr
    u_b[:K, :n] = ub_arr
    l_b[:K, n_pad:n_pad + m] = bls
    u_b[:K, n_pad:n_pad + m] = bus
    in_pack[:, 2 * N_pad] = 1e-7
    in_pack[:K, 2 * N_pad] = tol_arr
    box_infeasible = np.any(l_b[:K] > u_b[:K] + tol_arr[:, None], axis=1)
    valid_b[:K] = ~box_infeasible
    # cold start for every lane (vectorized lp._cold_start; warm lanes
    # overwrite below).  Padded lanes keep the all-slack basis over the
    # all-zero padded LP and stay valid_b=0, so they never step.
    basis0_b[:] = np.arange(n_pad, N_pad, dtype=np.int64)
    at_upper0_b[:, :n_pad] = (cf[None, :n_pad] < 0) | \
        np.isinf(l_b[:, :n_pad])

    # ---- warm bases: remap into padded space, validate all at once
    warm_lanes: List[int] = []
    wb_raw: List[np.ndarray] = []
    ht_raw: List[Optional[np.ndarray]] = []
    for k in range(K):
        if not valid_b[k]:
            continue
        wb, wh = _unpack_warm(warm_list[k])
        if wb is None:
            continue
        wb = np.asarray(wb, np.int64).ravel()
        if wb.shape != (m,):
            notes_pre[k].append(
                f"warm_start_rejected: basis shape {wb.shape} != "
                f"({m},); cold start used")
            continue
        warm_lanes.append(k)
        wb_raw.append(wb)
        ht_raw.append(wh)
    if warm_lanes:
        lanes_w = np.asarray(warm_lanes)
        L = len(warm_lanes)
        # caller (n+m)-space indices into the padded space; padded
        # slacks sit on the padded rows
        WBr = np.stack(wb_raw)
        WB = np.empty((L, m_pad), np.int64)
        WB[:, :m] = np.where(WBr < n, WBr, n_pad + (WBr - n))
        WB[:, m:] = np.arange(n_pad + m, N_pad, dtype=np.int64)
        HT = np.zeros((L, N_pad), bool)
        hs = [None if wh is None else np.asarray(wh, bool).ravel()
              for wh in ht_raw]
        if all(h is not None and h.shape == (n + m,) for h in hs):
            WHr = np.stack(hs)
            HT[:, :n] = WHr[:, :n]
            HT[:, n_pad:n_pad + m] = WHr[:, n:]
        else:  # mixed / odd hint payloads: rare, keep the lane loop
            for i, h in enumerate(hs):
                if h is not None and h.shape == (n + m,):
                    HT[i, :n] = h[:n]
                    HT[i, n_pad:n_pad + m] = h[n:]
        ok, au, reasons = _validate_warm_batch(
            A, cf, l_b[lanes_w], u_b[lanes_w], tol_arr[lanes_w], WB, HT)
        acc = lanes_w[ok]
        basis0_b[acc] = WB[ok]
        at_upper0_b[acc] = au[ok]
        for i in np.flatnonzero(~ok):
            notes_pre[lanes_w[i]].append(
                f"warm_start_rejected: {reasons[i]}; cold start used")

    results: List[Optional[LPResult]] = [None] * K
    for k in np.flatnonzero(box_infeasible):
        results[k] = _infeasible_result(n, m)
    if not np.any(valid_b):
        return results, [None] * K, 0     # every lane decided on the host

    in_pack[0, 3 * N_pad + 2 + m_pad] = K * cap if pivot_cap is None \
        else pivot_cap
    solver = _lane_solver(m_pad, n_pad, K_pad, cap, refactor_every, device)
    out = solver(shared["cf_dev"], shared["A_dev"], in_pack)
    # unpack + un-pad ALL lanes vectorized
    o = N_pad + m_pad
    x_b = out[:K, :n]
    y_b = out[:K, N_pad:N_pad + m] * scale
    obj_b = out[:K, o]
    basis_b = out[:K, o + 1:o + 1 + m].astype(np.int64)
    basis_b = np.where(basis_b < n_pad, basis_b, n + (basis_b - n_pad))
    stats_i = out[:K, o + 1 + m_pad:o + 5 + m_pad].astype(np.int64)
    au = out[:K, o + 5 + m_pad:o + 5 + m_pad + N_pad]
    at_upper_b = np.concatenate(
        [au[:, :n], au[:, n_pad:n_pad + m]], axis=1) != 0.0
    spent = int(out[0, 2 * N_pad + 2 * m_pad + 5])
    lanes = [None] * K
    for k in range(K):
        if results[k] is None:
            st, it, nb, nd = (int(v) for v in stats_i[k])
            lanes[k] = _Lane(st, x_b[k], float(obj_b[k]), it, basis_b[k],
                             at_upper_b[k], y_b[k], nb, nd, notes_pre[k])
    return results, lanes, spent


def _monitor(monitor, lanes) -> None:
    live = [ln for ln in lanes if ln is not None]
    n_bland = sum(ln.n_bland for ln in live)
    n_drift = sum(ln.n_drift for ln in live)
    if monitor is not None:
        monitor.bland_pivots += n_bland
        monitor.drift_refactors += n_drift
        if n_bland:
            monitor.stall_events += 1


def solve_lp_batch(c, A_t, bl, bu, ub_batch, lb_batch=None, *,
                   tol=1e-7, max_iters: int = 5000, warm_starts=None,
                   budget: Optional[SolveBudget] = None,
                   monitor: Optional[NumericalMonitor] = None,
                   backend: str = "auto",
                   refactor_every: int = REFACTOR_EVERY,
                   device="cuda") -> List[LPResult]:
    """Solve K bound-variants of one shared LP as one batched dispatch.

    ``(c, A_t, bl, bu)`` are shared; ``ub_batch`` / ``lb_batch`` are
    length-K sequences of per-variable bounds (``ub_batch`` entries must
    be given; ``lb`` defaults to 0).  ``tol`` is a scalar or a length-K
    sequence (the shading ladder relaxes tolerance per lane).
    ``warm_starts`` is ``None`` or a length-K sequence of per-lane
    ``LPResult`` / ``WarmStart`` / ``(basis, at_upper)`` / ``None``.

    Returns a list of K ``LPResult`` in input order, each carrying the
    same status codes, notes and warm-start semantics as the single
    twins.  ``backend="auto"`` runs the sequential numpy twin for K <= 2
    (K = 1 is bit-compatible with ``solve_lp_np``; the reference's rule)
    and the batched engine on ``device`` above; ``"np"`` forces the
    sequential loop, ``"device"`` the batched engine (the reference's
    ``"jax"``).  The batched engine launches ``csrc/lp_batch.cu`` on a
    CUDA ``device`` (default ``"cuda"``; raises without a card or if the
    kernel cannot be built) and runs its plain version on ``"cpu"``.
    """
    if backend == "jax":
        raise ValueError("backend 'jax' is the reference's name; the port's "
                         "batched engine is backend='device'")
    if backend not in ("auto", "np", "device"):
        raise ValueError(f"unknown backend {backend!r}")
    ub_batch = list(ub_batch)
    K = len(ub_batch)
    if K == 0:
        return []
    c = np.asarray(c, np.float64)
    A_t = np.atleast_2d(np.asarray(A_t, np.float64))
    m, n = A_t.shape
    ub_arr = _as_bound_arr(ub_batch, K, n, np.inf, "ub_batch")
    lb_arr = _as_bound_arr(lb_batch, K, n, 0.0, "lb_batch")
    tol_arr = (np.full(K, float(tol)) if np.isscalar(tol)
               else np.asarray([float(t) for t in tol], np.float64))
    if tol_arr.shape != (K,):
        raise ValueError(f"tol length {tol_arr.shape[0]} != K={K}")
    warm_list = list(warm_starts) if warm_starts is not None \
        else [None] * K
    if len(warm_list) != K:
        raise ValueError(f"warm_starts length {len(warm_list)} != K={K}")

    with _STATS_LOCK:
        _STATS["instances"] += K
    if backend == "np" or (backend == "auto" and K <= _AUTO_NP_MAX):
        # sequential path: per-call budget charging, identical to the
        # caller loops (this is what makes W=1 bit-compatible)
        with _STATS_LOCK:
            _STATS["np_fallbacks"] += 1
        return [solve_lp_np(c, A_t, bl, bu, ub_arr[k], lb=lb_arr[k],
                            max_iters=max_iters, tol=float(tol_arr[k]),
                            warm_start=warm_list[k], budget=budget,
                            monitor=monitor, refactor_every=refactor_every)
                for k in range(K)]

    dev = resolve_device(device)
    with _STATS_LOCK:
        _STATS["dispatches"] += 1
    cap = max_iters
    if budget is not None:
        budget.start()
        if budget.out_of_time() or budget.remaining_pivots() <= 0:
            return [_infeasible_result(
                n, m, "budget: exhausted before LP solve", BUDGET)
                for _ in range(K)]
        cap = budget.lp_iter_cap(max_iters)
    pivot_cap = K * cap
    if budget is not None:
        pivot_cap = int(min(pivot_cap, max(budget.remaining_pivots(), 1)))
    results, lanes, spent = _dispatch(
        c, A_t, bl, bu, ub_arr, lb_arr, tol_arr, warm_list, cap=cap,
        pivot_cap=pivot_cap, refactor_every=refactor_every, device=dev)
    if all(ln is None for ln in lanes):
        return results                     # every lane decided on the host
    with _STATS_LOCK:
        _STATS["batched_pivots"] += spent
    shared_hit = spent >= pivot_cap
    if budget is not None:
        budget.charge_pivots(spent)
    _monitor(monitor, lanes)
    truncatable = budget is not None and (cap < max_iters or shared_hit
                                          or budget.exhausted())
    for k, lane in enumerate(lanes):
        if lane is None:
            continue
        st, notes = lane.status, lane.notes()
        if st == ITER_LIMIT and truncatable:
            st = BUDGET
            notes.append(f"budget: truncated at pivot cap {cap}")
        results[k] = lane.result(st, notes)
    return results
