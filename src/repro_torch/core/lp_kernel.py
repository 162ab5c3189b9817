"""Revised dual simplex on the device, driven by the CUDA kernels.

Port of ``repro.core.lp_kernel``.  Same pivot rules and revised-simplex
invariants as ``core.lp`` (incrementally maintained Binv / reduced costs /
xB, periodic refactorization, residual-drift gate, degenerate-streak
refactorization, warm starts) with the two O(n) procedures of every pivot
on the hand-written kernels:

  * pricing (alpha, BFRT ratios, flip costs, the finite ratios' range)
    -> ``kernels.pricing`` — a single fused pass over A per pivot, through
    one ``Pricer`` per solve (the loop constants checked once);
  * BFRT breakpoint selection -> ``kernels.bfrt`` (the whole bucketed
    select in one launch, its edges from pricing's range), through one
    ``Selector`` per solve.

The loop is a Python loop over pivots on device tensors.  Every decision
inside a pivot is a ``torch.where`` on the device, and the refactorization
gates for the next pivot are evaluated at the end of the current one, so
the host reads ONE small tensor per pivot: the status, the drift flag and
the refresh flag, together.  That read is a known per-pivot sync (a CUDA
graph or a persistent loop is later work).  The m x m ``Binv`` update and
the flip-absorption mat-vec stay plain torch, as the reference left them
to XLA.

With ``device="cpu"`` the kernels' plain versions run (the parity tests).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.guard import (DRIFT_TOL, NumericalMonitor,
                                    STALL_REFACTOR, SolveBudget, THETA_EPS)
from repro_torch.core.lp import (BUDGET, INFEASIBLE, ITER_LIMIT, OPTIMAL,
                                 LPResult, REFACTOR_EVERY, _prep)
from repro_torch.device import resolve_device
from repro_torch.kernels.bfrt import Selector
from repro_torch.kernels.pricing import Pricer


def _refreshed(cf, A, l, u, basis, in_basis, at_upper):
    """Full refactorization: (Binv, xB, d, y) from the basis.  ``Binv`` is
    made row-major, since its rows are the pricing kernel's ``rho``
    (``linalg.inv_ex`` returns a column-major matrix)."""
    Binv = torch.linalg.inv_ex(A[:, basis])[0].contiguous()
    xN = torch.where(in_basis, 0.0, torch.where(at_upper, u, l))
    xN = xN.index_fill(0, basis, 0.0)
    xB = -Binv @ (A @ xN)
    y = Binv.T @ cf[basis]
    d = (cf - A.T @ y).index_fill(0, basis, 0.0)
    return Binv, xB, d, y


def _solve(cf, A, l, u, basis0, at_upper0, max_iters: int,
           refactor_every: int = REFACTOR_EVERY):
    dev, dt = A.device, A.dtype
    m, N = A.shape
    n = N - m
    tol = 1e-7
    iN = torch.arange(N, dtype=torch.int64, device=dev)
    im = torch.arange(m, dtype=torch.int64, device=dev)
    eye = torch.eye(m, dtype=dt, device=dev)
    K = torch.tensor(refactor_every, dtype=torch.int64, device=dev)
    zero_i = torch.zeros((), dtype=torch.int64, device=dev)
    # pricing's bound arrays are loop constants
    lo_safe = torch.where(torch.isfinite(l), l, 0.0)
    width = torch.where(torch.isfinite(u - l), u - l, 1e30)
    hi_safe = lo_safe + width
    price = Pricer(A, lo_safe, hi_safe)      # checks them once
    select = Selector(N, dev)

    basis = basis0
    in_basis = torch.zeros(N, dtype=torch.bool, device=dev)
    in_basis[basis] = True
    at_upper = at_upper0 & ~in_basis
    Binv = eye.clone()
    xB = torch.zeros(m, dtype=dt, device=dev)
    d = cf.clone()
    y = torch.zeros(m, dtype=dt, device=dev)
    stall = zero_i
    since = K.clone()                 # factorize on entry, cold and warm

    def gates():
        """(drift, refresh?) for the state the next pivot starts from: the
        reference's two gates at the top of its loop body."""
        resid = (Binv @ A[:, basis] - eye).abs().max()
        drift = (resid > DRIFT_TOL) & (since > 0)
        viol = torch.maximum(l[basis] - xB, xB - u[basis])
        suspect = (viol.max() <= tol) & (since > 0)
        return drift, drift | (since >= K) | suspect

    def read(*flags):
        """The pivot loop's one host read: small int tensors, one copy."""
        return torch.cat([f.reshape(1).to(torch.int64)
                          for f in flags]).cpu().tolist()

    drift, flag = read(*gates())
    status, it, n_drift = ITER_LIMIT, 0, 0
    while status == ITER_LIMIT and it < max_iters:
        n_drift += drift
        if flag:
            Binv, xB, d, y = _refreshed(cf, A, l, u, basis, in_basis,
                                        at_upper)
            since = zero_i
        # r and q are 1-element tensors, never 0-d ones: torch turns a 0-d
        # index into a Python int, which is a host sync
        lB, uB = l[basis], u[basis]
        viol_lo = lB - xB
        viol_hi = xB - uB
        viol = torch.maximum(viol_lo, viol_hi)
        r = torch.argmax(viol).reshape(1)
        done = viol[r] <= tol
        above = viol_hi[r] >= viol_lo[r]
        delta = torch.where(above, xB[r] - uB[r], xB[r] - lB[r])
        s = torch.where(delta > 0, 1.0, -1.0).to(dt)
        rho = Binv[r].squeeze(0)

        # ---- CUDA kernel: fused pricing, the single O(mN) sweep of A ----
        state_code = torch.where(in_basis, 2, torch.where(at_upper, 1, 0)
                                 ).to(torch.int32)
        alpha, ratio, cost, rng = price(rho, d, state_code, s)
        # ---- CUDA kernel: the bucketed BFRT select, one launch ----
        q, flip_mask, has_cross = select(ratio, cost, delta.abs(), rng=rng)

        stale = since > 0
        w = Binv @ A[:, q].squeeze(1)
        # unsafe pivot on drifted factors -> refactorize-and-retry
        unsafe = w[r].abs() < 1e-11
        no_pivot = ~has_cross
        new_status = torch.where(
            done, OPTIMAL, torch.where(no_pivot & ~stale, INFEASIBLE,
                                       ITER_LIMIT))
        do_pivot = (new_status == ITER_LIMIT) & ~no_pivot & ~unsafe

        # ---- incremental pivot (no inverse, no full d recompute) ----
        leave = basis[r]
        dxN = torch.where(flip_mask, torch.where(at_upper, l - u, u - l),
                          0.0)
        xB2 = xB - Binv @ (A @ dxN)      # flip absorption (masked matvec)
        at_upper_f = at_upper ^ flip_mask
        wr = torch.where(unsafe, 1.0, w[r])
        target = torch.where(above, uB[r], lB[r])
        t = (xB2[r] - target) / wr
        xq = torch.where(at_upper_f[q], u[q], l[q])
        xB3 = torch.where(im == r, xq + t, xB2 - t * w)
        theta = d[q] / wr
        d2 = torch.where(iN == leave, -theta,
                         torch.where(iN == q, 0.0, d - theta * alpha))
        y2 = y + theta * rho
        Binv_r = Binv[r].squeeze(0) / wr
        Binv2 = torch.where((im == r)[:, None], Binv_r[None, :],
                            Binv - torch.outer(w, Binv_r))
        at_upper2 = torch.where(iN == q, False,
                                torch.where(iN == leave, above, at_upper_f))
        in_basis2 = torch.where(iN == q, True,
                                torch.where(iN == leave, False, in_basis))
        basis2 = torch.where(im == r, q, basis)

        basis = torch.where(do_pivot, basis2, basis)
        in_basis = torch.where(do_pivot, in_basis2, in_basis)
        at_upper = torch.where(do_pivot, at_upper2, at_upper)
        Binv = torch.where(do_pivot, Binv2, Binv)
        xB = torch.where(do_pivot, xB3, xB)
        d = torch.where(do_pivot, d2, d)
        y = torch.where(do_pivot, y2, y)
        since = torch.where(do_pivot, since + 1,
                            torch.where((no_pivot | unsafe) & stale, K,
                                        since))
        # degenerate-pivot streak -> forced refactorization (anti-cycling)
        degen = do_pivot & (theta.abs() <= THETA_EPS)
        progress = do_pivot & (theta.abs() > THETA_EPS)
        stall = torch.where(progress, zero_i,
                            torch.where(degen, stall + 1, stall))
        since = torch.where(degen & (stall == STALL_REFACTOR), K, since)
        it += 1
        status, drift, flag = read(new_status, *gates())

    Binv, xB, d, y = _refreshed(cf, A, l, u, basis, in_basis, at_upper)
    xN = torch.where(in_basis, 0.0, torch.where(at_upper, u, l))
    xN = xN.index_fill(0, basis, 0.0)
    x = xN.index_copy(0, basis, xB)
    obj = cf @ torch.where(torch.isfinite(x), x, 0.0)
    return (status, x[:n].cpu().numpy(), float(obj), it,
            basis.cpu().numpy(), at_upper.cpu().numpy(), y.cpu().numpy(),
            n_drift)


def solve_lp_kernel(c, A_t, bl, bu, ub, *, lb: Optional[np.ndarray] = None,
                    max_iters: int = 5000, warm_start=None,
                    budget: Optional[SolveBudget] = None,
                    monitor: Optional[NumericalMonitor] = None,
                    device="cuda") -> LPResult:
    """Kernel-backed twin of ``core.lp.solve_lp_np`` (same conventions,
    including the warm-start and budget/monitor contracts).  ``device``
    defaults to CUDA and raises when there is none."""
    dev = resolve_device(device)
    arrs, scale, m, n, start = _prep(c, A_t, bl, bu, ub, lb, warm_start)
    if arrs is None:
        return LPResult(INFEASIBLE, np.zeros(n), 0.0, 0,
                        np.arange(n, n + m), np.zeros(n + m, bool),
                        np.zeros(m))
    cf, A, l, u = arrs
    basis0, at_upper0, _, wnote = start
    notes = [] if wnote is None else [wnote]
    cap = max_iters
    if budget is not None:
        budget.start()
        if budget.out_of_time() or budget.remaining_pivots() <= 0:
            notes.append("budget: exhausted before LP solve")
            return LPResult(BUDGET, np.zeros(n), 0.0, 0,
                            np.asarray(basis0),
                            np.asarray(at_upper0, bool), np.zeros(m),
                            notes=tuple(notes))
        cap = budget.lp_iter_cap(max_iters)

    def t(a, dtype=torch.float64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    status, x, obj, it, basis, at_upper, y, n_drift = _solve(
        t(cf), t(A), t(l), t(u), t(basis0, torch.int64),
        t(at_upper0, torch.bool), cap)
    if n_drift:
        notes.append(f"drift: {n_drift} forced refactorizations")
    if monitor is not None:
        monitor.drift_refactors += n_drift
    if budget is not None:
        budget.charge_pivots(it)
        if status == ITER_LIMIT and (cap < max_iters
                                     or budget.exhausted()):
            status = BUDGET
            notes.append(f"budget: truncated at pivot cap {cap}")
    return LPResult(status, x, obj, it, basis, at_upper, y * scale,
                    notes=tuple(notes))
