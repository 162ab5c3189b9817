"""Bound-variant LP flights (``repro.core.lp_batch``), sequential dispatch.

Branch & bound, the Dual Reducer's auxiliary re-solves and the shading
ladder generate flights of LPs that share one ``(c, A)`` and differ only
in variable bounds.  The reference solves wide flights as one batched
jitted dispatch; the port carries the sequential path that the main path
reaches (B&B at ``wave_width=1``, Dual Reducer at ``aux_rungs=1``, the
two-lane shading ladder): one ``solve_lp_np`` per lane, with per-call
budget charging, bit-compatible with the reference's fallback.  The
batched device engine is later work (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.core.guard import NumericalMonitor, SolveBudget
from repro_torch.core.lp import LPResult, REFACTOR_EVERY, solve_lp_np

# ``backend="auto"`` routes flights of at most this many lanes to the
# sequential loop (the reference's crossover)
_AUTO_NP_MAX = 2


def _as_bound_arr(batch, K: int, n: int, default: float,
                  name: str) -> np.ndarray:
    """Normalize ub_batch / lb_batch into one (K, n) float64 array."""
    if batch is None:
        return np.full((K, n), default)
    try:
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


def solve_lp_batch(c, A_t, bl, bu, ub_batch, lb_batch=None, *,
                   tol=1e-7, max_iters: int = 5000, warm_starts=None,
                   budget: Optional[SolveBudget] = None,
                   monitor: Optional[NumericalMonitor] = None,
                   backend: str = "auto",
                   refactor_every: int = REFACTOR_EVERY) -> List[LPResult]:
    """Solve K bound-variants of one shared LP; a list of K ``LPResult``.

    Same arguments as the reference.  ``backend="np"`` and ``"auto"`` with
    K <= 2 run the sequential numpy loop; the batched engine
    (``backend="jax"``, or ``"auto"`` with K > 2) is not ported yet and
    raises ``NotImplementedError``.
    """
    if backend not in ("auto", "np", "jax"):
        raise ValueError(f"unknown backend {backend!r}")
    ub_batch = list(ub_batch)
    K = len(ub_batch)
    if K == 0:
        return []
    if backend == "jax" or (backend == "auto" and K > _AUTO_NP_MAX):
        raise NotImplementedError(
            "the batched bound-variant LP engine is not ported yet "
            "(ROADMAP queue 1: lp_batch batched engine); use "
            "backend='np' or flights of at most 2 lanes")
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
    return [solve_lp_np(c, A_t, bl, bu, ub_arr[k], lb=lb_arr[k],
                        max_iters=max_iters, tol=float(tol_arr[k]),
                        warm_start=warm_list[k], budget=budget,
                        monitor=monitor, refactor_every=refactor_every)
            for k in range(K)]
