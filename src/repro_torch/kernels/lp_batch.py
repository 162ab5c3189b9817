"""The batched bound-variant LP engine's device kernel and its plain version.

Replaces ``repro/core/lp_batch.py::_batched_core``: K revised-dual-simplex
solves with the bound-flipping ratio test that share one ``(cf, A)`` and
differ in bounds, tolerance and starting basis (a B&B wave, the Dual
Reducer's auxiliary rungs), as one jitted, vmapped ``lax.while_loop``
over the single twin's pivot pieces (``repro/core/lp.py:471-727``).

Both versions take the reference's packed layouts (``in_width`` and
``out_width``; one host-to-device copy in, one back):

    in_pack  (K_pad, 3N + m_pad + 3) = [l | u | tol | basis0 | at_upper0 |
                                        valid | pivot_cap (row 0)]
    out_pack (K_pad, 2N + 2 m_pad + 6) = [x | y | obj | basis | status |
                                          it | n_bland | n_drift |
                                          at_upper | spent]

:func:`lp_batch_plain` is the reference's loop in torch, batched on a
leading lane axis: the eager refresh, per trip the drift and
optimal-suspect gates with one batch-level refresh on the union of the
active lanes' ``need`` bits, the pivot on active lanes only (frozen lanes
pass through unchanged), the shared pivot cap checked before every trip,
and the exit refresh of lanes with ``since > 0``.  Ties break as JAX's do:
first index for argmax/argmin, a stable sort by (ratio, index).  It runs
on any device; the CPU tests and ``chip_smoke.py`` hold the kernel to it.

:class:`LaneSolver` is the per-shape-class launch workspace (made once
per ``(m_pad, n_pad, K_pad, max_iters, refactor_every)``, like
``Pricer``): given CUDA ``(cf, A)`` a call launches ``csrc/lp_batch.cu``
once, each lane run to its own end (the kernel needs no grid-wide sync:
in the reference lanes interact only through the shared cap), on the
path the kernel's plan gives the class (``LaneSolver.plan``): one warp a
lane, several lanes a CTA, for m_pad <= 32 and N <= ``WARP_N_MAX``;
one CTA a lane for the rest.  If the lanes' trips reach ``pivot_cap``
it finds the least lockstep trip count T that spends the cap,
``sum_k min(it_k, T) >= pivot_cap``, and launches once more with every
lane limited to T trips, which is the lockstep loop's result exactly.
Given CPU tensors it runs the plain version.  Its buffers serve one
flight at a time: a call holds the solver's lock from the copy in to the
copy out, so threads that dispatch the same shape class take turns.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.guard import (DRIFT_TOL, STALL_BLAND, STALL_REFACTOR,
                                    THETA_EPS)
from repro_torch.core.lp import INFEASIBLE, ITER_LIMIT, OPTIMAL
from repro_torch.kernels import _build
from repro_torch.runtime.racecheck import InstrumentedLock, checkpoint

launches = 0

M_PAD_MAX = 4096             # rows the kernel takes (m_pad, a power of two)

_SIG = {"lp_batch_f64": (_build.P, _build.P, _build.P, _build.P, _build.P,
                         _build.I64, _build.I64, _build.I64, _build.I64,
                         _build.I64, _build.I64, _build.P),
        "lp_batch_ws_lane_bytes": (_build.I64, _build.I64),
        "lp_batch_plan": (_build.I64, _build.I64, _build.I64, _build.P)}


def in_width(N: int, m_pad: int) -> int:
    return 3 * N + m_pad + 3


def out_width(N: int, m_pad: int) -> int:
    return 2 * N + 2 * m_pad + 6


# ------------------------------------------------------- the plain version


def _rows(t, idx):
    """t[k, idx[k]] for a (K, ...) tensor and (K,) indices."""
    return t.gather(1, idx[:, None]).squeeze(1)


def _refreshed(cf, A, l, u, basis, in_basis, at_upper):
    """repro/core/lp.py::_refreshed on every lane: (Binv, xB, d, y)."""
    B = A[:, basis].permute(1, 0, 2)                 # (K, m, m)
    Binv = torch.linalg.inv_ex(B).inverse
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    xN = torch.where(in_basis, zero, torch.where(at_upper, u, l))
    xB = -(Binv @ (xN @ A.T)[..., None])[..., 0]
    y = (Binv.transpose(1, 2) @ cf[basis][..., None])[..., 0]
    d = torch.where(in_basis, zero, cf - y @ A)
    return Binv, xB, d, y


def _refresh_where(cf, A, l, u, st, mask):
    """_factor_refresh on the lanes of ``mask`` (every lane computed, the
    rest kept, as the reference's tree select does)."""
    Binv, xB, d, y = _refreshed(cf, A, l, u, st["basis"], st["in_basis"],
                                st["at_upper"])
    k = mask[:, None]
    st["Binv"] = torch.where(mask[:, None, None], Binv, st["Binv"])
    st["xB"] = torch.where(k, xB, st["xB"])
    st["d"] = torch.where(k, d, st["d"])
    st["y"] = torch.where(k, y, st["y"])
    st["since"] = torch.where(mask, 0, st["since"])


def _viol(l, u, st):
    lB = l.gather(1, st["basis"])
    uB = u.gather(1, st["basis"])
    return lB, uB, lB - st["xB"], st["xB"] - uB


def _pivot_core(cf, A, l, u, tol, refactor_every, st, active):
    """repro/core/lp.py::_pivot_core with ``active=``, on every lane."""
    basis, in_basis, at_upper = st["basis"], st["in_basis"], st["at_upper"]
    Binv, xB, d, y = st["Binv"], st["xB"], st["d"], st["y"]
    bland, since = st["bland"], st["since"]
    K, m = basis.shape
    N = A.shape[1]
    dt, dev = A.dtype, A.device
    lB, uB, viol_lo, viol_hi = _viol(l, u, st)
    viol = torch.maximum(viol_lo, viol_hi)
    r_max = torch.argmax(viol, 1)
    done = _rows(viol, r_max) <= tol
    r_bland = torch.argmin(torch.where(viol > tol[:, None], basis, N), 1)
    r = torch.where(bland, r_bland, r_max)

    above = _rows(viol_hi, r) >= _rows(viol_lo, r)
    xBr = _rows(xB, r)
    delta = torch.where(above, xBr - _rows(uB, r), xBr - _rows(lB, r))
    s = torch.where(delta > 0, 1.0, -1.0).to(dt)
    rho = Binv.gather(1, r[:, None, None].expand(K, 1, m))[:, 0]
    alpha = rho @ A                                  # pricing

    sa = s[:, None] * alpha
    tc = tol[:, None]
    elig = (~in_basis) & (((~at_upper) & (sa > tc)) | (at_upper & (sa < -tc)))
    any_elig = elig.any(1)
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    ratio = torch.where(elig, torch.maximum(
        d / torch.where(sa.abs() > tc, sa, one), zero), inf)
    width = u - l
    flip_cost = torch.where(elig, alpha.abs() * width, zero)

    order = torch.argsort(ratio, dim=1, stable=True)
    csum = torch.cumsum(flip_cost.gather(1, order), 1)
    elig_sorted = elig.gather(1, order)
    crossed = (csum >= (delta.abs() - 1e-12)[:, None]) & elig_sorted
    cross_pos = torch.argmax(crossed.to(torch.int8), 1)
    rmin = ratio.min(1).values
    q_bland = torch.argmax((elig & (ratio <= (rmin + 1e-12)[:, None]))
                           .to(torch.int8), 1)
    has_cross = crossed.any(1) | (bland & any_elig)
    q = torch.where(bland, q_bland, _rows(order, cross_pos))
    iN = torch.arange(N, device=dev)
    ratio_q = _rows(ratio, q)[:, None]
    flip_mask = (elig & ~bland[:, None]
                 & ((ratio < ratio_q)
                    | ((ratio == ratio_q) & (iN[None, :] < q[:, None]))))

    stale = since > 0
    w = (Binv @ A[:, q].T[..., None])[..., 0]
    w_r = _rows(w, r)
    unsafe = w_r.abs() < 1e-11
    no_pivot = ~any_elig | ~has_cross
    new_status = torch.where(
        done, OPTIMAL, torch.where(no_pivot & ~stale, INFEASIBLE,
                                   ITER_LIMIT))
    do_pivot = (new_status == ITER_LIMIT) & ~no_pivot & ~unsafe & active

    # ---- the incremental pivot
    leave = _rows(basis, r)
    im = torch.arange(m, device=dev)
    dxN = torch.where(flip_mask, torch.where(at_upper, l - u, u - l), zero)
    xB2 = xB - (Binv @ (dxN @ A.T)[..., None])[..., 0]
    at_upper_f = at_upper ^ flip_mask
    wr = torch.where(unsafe, one, w_r)
    target = torch.where(above, _rows(uB, r), _rows(lB, r))
    t = (_rows(xB2, r) - target) / wr
    xq = torch.where(_rows(at_upper_f, q), _rows(u, q), _rows(l, q))
    xB3 = torch.where(im[None, :] == r[:, None], (xq + t)[:, None],
                      xB2 - t[:, None] * w)
    theta = _rows(d, q) / wr
    is_leave = iN[None, :] == leave[:, None]
    is_q = iN[None, :] == q[:, None]
    d2 = torch.where(is_leave, -theta[:, None],
                     torch.where(is_q, zero, d - theta[:, None] * alpha))
    y2 = y + theta[:, None] * rho
    Binv_r = rho / wr[:, None]
    Binv2 = torch.where((im[None, :] == r[:, None])[:, :, None],
                        Binv_r[:, None, :],
                        Binv - w[:, :, None] * Binv_r[:, None, :])
    at_upper2 = torch.where(is_q, False,
                            torch.where(is_leave, above[:, None], at_upper_f))
    in_basis2 = torch.where(is_q, True, torch.where(is_leave, False,
                                                    in_basis))
    basis2 = torch.where(im[None, :] == r[:, None], q[:, None], basis)

    dp = do_pivot[:, None]
    st["basis"] = torch.where(dp, basis2, basis)
    st["in_basis"] = torch.where(dp, in_basis2, in_basis)
    st["at_upper"] = torch.where(dp, at_upper2, at_upper)
    st["Binv"] = torch.where(dp[:, :, None], Binv2, Binv)
    st["xB"] = torch.where(dp, xB3, xB)
    st["d"] = torch.where(dp, d2, d)
    st["y"] = torch.where(dp, y2, y)
    since2 = torch.where(do_pivot, since + 1,
                         torch.where((no_pivot | unsafe) & stale,
                                     refactor_every, since))

    # ---- anti-cycling: degenerate (theta ~ 0) pivot streaks
    degen = do_pivot & (theta.abs() <= THETA_EPS)
    progress = do_pivot & (theta.abs() > THETA_EPS)
    n_bland = st["n_bland"] + (bland & do_pivot)
    stall = torch.where(progress, 0, torch.where(degen, st["stall"] + 1,
                                                 st["stall"]))
    bland2 = torch.where(progress, False, bland | (stall >= STALL_BLAND))
    since2 = torch.where(degen & (stall == STALL_REFACTOR), refactor_every,
                         since2)
    # frozen lanes: every scalar field passes through
    st["status"] = torch.where(active, new_status, st["status"])
    st["it"] = torch.where(active, st["it"] + 1, st["it"])
    st["since"] = torch.where(active, since2, since)
    st["stall"] = torch.where(active, stall, st["stall"])
    st["bland"] = torch.where(active, bland2, bland)
    st["n_bland"] = torch.where(active, n_bland, st["n_bland"])


def lp_batch_plain(cf, A, in_pack, *, max_iters: int,
                   refactor_every: int):
    """The reference's batched solve in torch (any device): ``cf`` (N,),
    ``A`` (m_pad, N) and ``in_pack`` float64 on one device; returns the
    out pack.  Lanes move in lockstep, one trip each per loop iteration,
    until none is active or the shared ``pivot_cap`` (in_pack[0, -1]) is
    spent; ``spent`` is the pivots the active lanes took."""
    m, N = A.shape
    dev, dt = A.device, A.dtype
    K = in_pack.shape[0]
    l, u = in_pack[:, :N], in_pack[:, N:2 * N]
    tol = in_pack[:, 2 * N]
    basis0 = in_pack[:, 2 * N + 1:2 * N + 1 + m].to(torch.int64)
    at_upper0 = in_pack[:, 2 * N + 1 + m:3 * N + 1 + m] != 0.0
    valid = in_pack[:, 3 * N + 1 + m] != 0.0
    pivot_cap = int(in_pack[0, 3 * N + 2 + m])

    iN = torch.arange(N, device=dev)
    in_basis0 = (basis0[:, :, None] == iN[None, None, :]).any(1)
    zi = torch.zeros(K, dtype=torch.int64, device=dev)
    st = {"basis": basis0, "in_basis": in_basis0,
          "at_upper": at_upper0 & ~in_basis0,
          "Binv": torch.eye(m, dtype=dt, device=dev).expand(K, m, m).clone(),
          "xB": torch.zeros(K, m, dtype=dt, device=dev),
          "d": cf.expand(K, N).clone(),
          "y": torch.zeros(K, m, dtype=dt, device=dev),
          "stall": zi, "bland": torch.zeros(K, dtype=torch.bool, device=dev),
          "n_bland": zi, "n_drift": zi, "status": zi + ITER_LIMIT, "it": zi,
          "since": zi + refactor_every}
    # eager factorization of every lane before the loop
    _refresh_where(cf, A, l, u, st, torch.ones(K, dtype=torch.bool,
                                               device=dev))
    eye = torch.eye(m, dtype=dt, device=dev)
    spent = 0
    while True:
        act = valid & (st["status"] == ITER_LIMIT) & (st["it"] < max_iters)
        if not (bool(act.any()) and spent < pivot_cap):
            break
        # drift gate (drift events on frozen lanes do not count)
        B = A[:, st["basis"]].permute(1, 0, 2)
        resid = (st["Binv"] @ B - eye).abs().amax((1, 2))
        drift = (resid > DRIFT_TOL) & (st["since"] > 0)
        st["n_drift"] = torch.where(act, st["n_drift"] + drift,
                                    st["n_drift"])
        need1 = drift | (st["since"] >= refactor_every)
        # optimal-suspect gate, on the same factors
        viol = torch.maximum(*_viol(l, u, st)[2:])
        need2 = (_rows(viol, torch.argmax(viol, 1)) <= tol) \
            & (st["since"] > 0)
        need = (need1 | need2) & act
        if bool(need.any()):
            _refresh_where(cf, A, l, u, st, need)
        _pivot_core(cf, A, l, u, tol, refactor_every, st, act)
        spent += int(act.sum())

    # exit contract: lanes truncated mid-streak get fresh factors
    need_exit = st["since"] > 0
    if bool(need_exit.any()):
        _refresh_where(cf, A, l, u, st, need_exit)
    # repro/core/lp.py::_gather_solution
    basis, in_basis, at_upper = st["basis"], st["in_basis"], st["at_upper"]
    zero = torch.zeros((), dtype=dt, device=dev)
    xN = torch.where(in_basis, zero, torch.where(at_upper, u, l))
    pos = torch.argmax((basis[:, :, None] == iN[None, None, :])
                       .to(torch.int8), 1)
    x = torch.where(in_basis, st["xB"].gather(1, pos), xN)
    obj = torch.where(torch.isfinite(x), x, zero) @ cf
    col = lambda v: v.to(dt)[:, None]   # noqa: E731
    return torch.cat([x, st["y"], obj[:, None], basis.to(dt),
                      col(st["status"]), col(st["it"]), col(st["n_bland"]),
                      col(st["n_drift"]), at_upper.to(dt),
                      torch.full((K, 1), float(spent), dtype=dt,
                                 device=dev)], 1)


KEY_NAN = 2 ** 64 - 2        # the kernel's key of a NaN ratio


def order_keys(ratio) -> np.ndarray:
    """The kernel's 64-bit keys of float64 ratios (``order_bits``): in
    numpy's sort order, -0 equal to +0, every NaN one key after +inf."""
    r = np.asarray(ratio, np.float64) + 0.0
    b = r.view(np.int64)
    k = np.where(b < 0, ~b.view(np.uint64),
                 b.view(np.uint64) | np.uint64(1 << 63))
    return np.where(np.isnan(r), np.uint64(KEY_NAN), k)


def bfrt_merge_walk_plain(ratio, cost, elig, delta: float, lanes: int = 32):
    """The warp path's BFRT select, round for round (tests only): thread t
    of ``lanes`` (a power of two) owns columns t, t + lanes, ...  First
    the shortcut: with no negative cost, when the sum of the eligible
    costs (each thread's in column order, then a butterfly over the
    threads) times 1 + (4k + 32) 2^-53 is below |delta| - 1e-12, no
    running sum can reach it and there is no crossing.  Else each
    thread's run is its eligible columns sorted by key (stable); the
    merge takes the least (key, index) run head, adds its cost to the
    running sum from 0, and stops at the first whose sum reaches the
    threshold.  Returns (q, flips, base, has_cross, walked): q the
    crossing column (-1 without one), flips the columns consumed before
    it (none when q's ratio is NaN), base the running sum where the
    merge stopped (the butterfly's sum after the shortcut), walked
    whether the merge ran."""
    ratio = np.asarray(ratio, np.float64)
    cost = np.asarray(cost, np.float64)
    elig = np.asarray(elig, bool)
    N = len(ratio)
    keys = order_keys(ratio)
    thr = abs(float(delta)) - 1e-12
    cols = [np.arange(t, N, lanes) for t in range(lanes)]
    cols = [c[elig[c]] for c in cols]
    part = []
    for c in cols:
        total = 0.0
        for j in c:
            total = total + float(cost[j])
        part.append(total)
    o = lanes // 2
    while o:
        part = [part[t] + part[t ^ o] for t in range(lanes)]
        o //= 2
    k = int(elig.sum())
    if k and not np.any(cost[elig] < 0) \
            and part[0] * (1.0 + (4.0 * k + 32.0) * 2.0 ** -53) < thr:
        return -1, np.zeros(N, bool), part[0], False, False
    runs = [c[np.argsort(keys[c], kind="stable")].tolist() for c in cols]
    heads = [0] * lanes
    base = 0.0
    consumed = np.zeros(N, bool)
    while True:
        live = [(int(keys[r[h]]), r[h], t)
                for t, (r, h) in enumerate(zip(runs, heads)) if h < len(r)]
        if not live:
            return -1, consumed, base, False, True
        key, j, t = min(live)
        base = base + float(cost[j])
        if base >= thr:
            flips = consumed if key != KEY_NAN else np.zeros(N, bool)
            return j, flips, base, True, True
        consumed[j] = True
        heads[t] += 1


# ------------------------------------------------------------- the kernel


def lockstep_trips(its: np.ndarray, pivot_cap: int) -> int:
    """The trips T the lockstep loop runs: the least T whose spend
    ``sum_k min(it_k, T)`` reaches ``pivot_cap``, else every lane's own
    end (``max it_k``).  ``its``: each valid lane's trips run alone."""
    its = np.asarray(its, np.int64)
    if not its.size:
        return 0
    top = int(its.max())
    if int(its.sum()) < pivot_cap:
        return top
    lo, hi = 0, top                    # spend(hi) >= pivot_cap
    while lo < hi:
        mid = (lo + hi) // 2
        if int(np.minimum(its, mid).sum()) >= pivot_cap:
            hi = mid
        else:
            lo = mid + 1
    return lo


class LaneSolver:
    """Launch workspace of one shape class: ``solver(cf, A, in_pack)``
    solves a flight (``in_pack`` a host float64 array of the in layout)
    and returns its out pack as a new host array, ``spent`` filled in.

    On a CUDA ``cf``/``A`` (float64, contiguous, ``cf`` (N,), ``A``
    (m_pad, N)) the call copies the in pack to the card through a pinned
    buffer, launches ``csrc/lp_batch.cu`` (on ``plan``'s path; a second
    launch only when the shared pivot cap truncates, see the module
    docstring) and copies the out pack back; a failed build or launch
    raises.  On CPU tensors it runs :func:`lp_batch_plain`.

    One call at a time: ``_lock`` is held over the whole call (the pinned
    and device packs, the workspace and both launches are the solver's
    own, shared by every dispatch of its class), so concurrent dispatches
    of one class are serialized and each reads back its own out pack.  A
    solver evicted from the class cache while a call runs stays alive
    until that call returns (the caller holds it).
    """

    __guarded_by__ = {"in_host": "_lock", "out_host": "_lock",
                      "in_dev": "_lock", "out_dev": "_lock", "ws": "_lock"}

    def __init__(self, m_pad: int, n_pad: int, K_pad: int, max_iters: int,
                 refactor_every: int, device):
        self.m_pad, self.n_pad, self.K_pad = m_pad, n_pad, K_pad
        self.N = n_pad + m_pad
        self.max_iters, self.refactor_every = max_iters, refactor_every
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.shape_in = (K_pad, in_width(self.N, m_pad))
        self.shape_out = (K_pad, out_width(self.N, m_pad))
        self._lock = InstrumentedLock("lane_solver")
        self.plan = {"path": "plain"}
        if not self.cuda:
            return
        if not (4 <= m_pad <= M_PAD_MAX and m_pad & (m_pad - 1) == 0):
            raise ValueError(f"lp_batch kernel: m_pad {m_pad} is not a "
                             f"power of two in [4, {M_PAD_MAX}]")
        f64 = dict(dtype=torch.float64, device=self.device)
        self.in_dev = torch.empty(self.shape_in, **f64)
        self.out_dev = torch.empty(self.shape_out, **f64)
        self.in_host = torch.empty(self.shape_in, dtype=torch.float64,
                                   pin_memory=True)
        self.out_host = torch.empty(self.shape_out, dtype=torch.float64,
                                    pin_memory=True)
        self.index = self.device.index if self.device.index is not None \
            else torch.cuda.current_device()
        self._bind(_build.load("lp_batch", _SIG))

    def _bind(self, lib) -> None:
        """Launch ``lib``'s kernel (a build of ``csrc/lp_batch.cu``) with
        the workspace its lanes need (lanes taller or wider than the
        kernel's shared memory keep their per-row or per-column state
        there), and read the path the kernel takes for this class
        (``plan``: "warp" or "cta", lanes a CTA, ``(cf, A)`` staged in
        shared memory, the CTA's dynamic shared bytes).  Under ``_lock``:
        a rebind never swaps the workspace under a running call."""
        ws_bytes = lib.lp_batch_ws_lane_bytes
        ws_bytes.restype = ctypes.c_int64
        lane_bytes = ws_bytes(self.m_pad, self.N)
        out = (ctypes.c_int64 * 4)()
        _build.check(lib.lp_batch_plan(self.m_pad, self.N, self.K_pad, out),
                     "lp_batch_plan")
        with self._lock:
            self.fn = lib.lp_batch_f64
            self.ws = torch.empty(self.K_pad * lane_bytes,
                                  dtype=torch.uint8, device=self.device) \
                if lane_bytes else None
            self.plan = {"path": "warp" if out[0] else "cta",
                         "lanes_per_cta": int(out[1]),
                         "staged": bool(out[2]), "smem_bytes": int(out[3])}

    def _launch(self, cf, A, trip_limit: int) -> None:
        global launches
        _build.check(self.fn(
            cf.data_ptr(), A.data_ptr(), self.in_dev.data_ptr(),
            self.out_dev.data_ptr(),
            self.ws.data_ptr() if self.ws is not None else None,
            self.m_pad, self.N, self.K_pad, self.max_iters, trip_limit,
            self.refactor_every, _build.stream_ptr(self.index)), "lp_batch")
        launches += 1

    def _read(self) -> np.ndarray:
        self.out_host.copy_(self.out_dev, non_blocking=True)
        torch.cuda.current_stream(self.index).synchronize()
        return self.out_host.numpy()

    def __call__(self, cf, A, in_pack: np.ndarray) -> np.ndarray:
        with self._lock:
            checkpoint("lane_solver.call")
            return self._solve(cf, A, in_pack)

    def _solve(self, cf, A, in_pack: np.ndarray) -> np.ndarray:
        in_pack = np.asarray(in_pack, np.float64)
        if in_pack.shape != self.shape_in:
            raise ValueError(f"lp_batch: in_pack {in_pack.shape} != "
                             f"{self.shape_in}")
        if A.shape != (self.m_pad, self.N) or cf.shape != (self.N,):
            raise ValueError(f"lp_batch: cf ({self.N},) and A ({self.m_pad}, "
                             f"{self.N}) expected")
        if not self.cuda:
            if cf.is_cuda or A.is_cuda:
                raise ValueError("lp_batch: CPU workspace given CUDA tensors")
            return lp_batch_plain(
                cf, A, torch.from_numpy(in_pack), max_iters=self.max_iters,
                refactor_every=self.refactor_every).numpy()
        for name, t in (("cf", cf), ("A", A)):
            if (t.dtype != torch.float64 or not t.is_cuda
                    or t.get_device() != self.index
                    or not t.is_contiguous()):
                raise ValueError(f"lp_batch: {name} must be contiguous "
                                 f"float64 on {self.device}")
        if self.plan["staged"] and (cf.data_ptr() | A.data_ptr()) % 16:
            raise ValueError("lp_batch: cf and A must start on 16-byte "
                             "boundaries (the kernel copies them into shared "
                             "memory in bulk)")
        N, m = self.N, self.m_pad
        self.in_host.numpy()[...] = in_pack
        self.in_dev.copy_(self.in_host, non_blocking=True)
        self._launch(cf, A, self.max_iters)
        out = self._read()
        valid = in_pack[:, 3 * N + 1 + m] != 0.0
        its = out[valid, N + 2 * m + 2].astype(np.int64)
        pivot_cap = int(in_pack[0, 3 * N + 2 + m])
        trips = lockstep_trips(its, pivot_cap)
        if its.size and trips < int(its.max()):
            # the shared cap stops the lockstep loop after `trips` trips
            self._launch(cf, A, trips)
            out = self._read()
            its = out[valid, N + 2 * m + 2].astype(np.int64)
        out = out.copy()
        out[:, 2 * N + 2 * m + 5] = float(its.sum())
        return out


def lane_mismatches(got: np.ndarray, want: np.ndarray, in_pack: np.ndarray,
                    m_pad: int, tol: float = 1e-9):
    """Hold two out packs of one flight lane by lane, on its valid lanes:
    equal status and iterations; unless the lane is infeasible also equal
    sorted basis and bound pattern, x within ``tol`` and the objective
    within ``tol`` x max(1, |objective|).  Returns (the lanes that
    differ, each with why; the largest |x| and objective differences)."""
    N = (in_pack.shape[1] - m_pad - 3) // 3
    o = N + m_pad
    valid = np.flatnonzero(in_pack[:, 3 * N + 1 + m_pad] != 0.0)
    bad, x_err, obj_err = [], 0.0, 0.0
    for k in valid:
        g, w = got[k], want[k]
        sg, sw = g[o + 1 + m_pad:o + 3 + m_pad], w[o + 1 + m_pad:o + 3 + m_pad]
        if not np.array_equal(sg, sw):
            bad.append((int(k), f"status, iters {sg.tolist()} != "
                                f"{sw.tolist()}"))
            continue
        if sw[0] == INFEASIBLE:
            continue
        dx = float(np.abs(g[:N] - w[:N]).max())
        do = abs(float(g[o] - w[o]))
        x_err, obj_err = max(x_err, dx), max(obj_err, do)
        if not np.array_equal(np.sort(g[o + 1:o + 1 + m_pad]),
                              np.sort(w[o + 1:o + 1 + m_pad])):
            bad.append((int(k), "basis"))
        elif not np.array_equal(g[o + 5 + m_pad:o + 5 + m_pad + N],
                                w[o + 5 + m_pad:o + 5 + m_pad + N]):
            bad.append((int(k), "at_upper"))
        elif not (dx <= tol and do <= tol * max(1.0, abs(float(w[o])))):
            bad.append((int(k), f"x err {dx}, obj err {do}"))
    return bad, x_err, obj_err
