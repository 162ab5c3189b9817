"""Fused dual-simplex pricing (paper App. C.3, procedure 1).

Replaces ``repro/kernels/pricing.py::_pricing_kernel`` (Pallas, TPU).
Per pivot the revised dual simplex needs, for every column j of A
(m x N, m tiny)::

    alpha_j = rho . A[:, j]
    ratio_j = max(d_j / (s * alpha_j), 0)  if BFRT-eligible, else +inf
    cost_j  = |alpha_j| * (hi_j - lo_j)    if eligible, else 0

``d`` is the maintained reduced-cost vector, so this is the single O(mN)
sweep of A per pivot.  On a CUDA tensor :func:`pricing` launches
``csrc/pricing.cu`` (one thread per column, rho in shared memory; bound by
the bytes of A it reads once — see the source note); on a CPU tensor it
runs :func:`pricing_plain`, which repeats the kernel's arithmetic in the
kernel's order, so the two agree bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0

_SIG = {fn: (_build.P,) * 7 + (_build.F64, _build.I64, _build.I64)
        + (_build.P,) * 4 for fn in ("pricing_f64", "pricing_f32")}


def pricing_plain(A, rho, d, state, lo, hi, s, tol: float = 1e-9):
    """Plain torch version (any device): same math, same summation order."""
    alpha = rho[0] * A[0]
    for r in range(1, A.shape[0]):
        alpha = alpha + rho[r] * A[r]
    sa = s * alpha
    nonbasic = state < 2
    at_up = state == 1
    elig = nonbasic & ((~at_up & (sa > tol)) | (at_up & (sa < -tol)))
    safe = torch.where(sa.abs() > tol, sa, torch.ones_like(sa))
    ratio = torch.where(elig, torch.clamp_min(d / safe, 0.0),
                        torch.full_like(sa, float("inf")))
    cost = torch.where(elig, alpha.abs() * (hi - lo), torch.zeros_like(sa))
    return alpha, ratio, cost


def pricing(A, rho, d, state, lo, hi, s, tol: float = 1e-9):
    """(alpha, ratio, cost) for every column of ``A`` (m, N).

    ``state``: int32 (N,) 0 = nonbasic at lower, 1 = at upper, 2 = basic;
    ``s``: the sign of the primal infeasibility, a 0-d tensor or a float
    (a tensor keeps the pivot loop free of host syncs).
    """
    global launches
    if A.device.type != "cuda":
        return pricing_plain(A, rho, d, state, lo, hi, s, tol)
    dt = A.dtype
    if dt not in (torch.float64, torch.float32):
        raise TypeError(f"pricing kernel takes float32/float64, got {dt}")
    m, N = A.shape
    s_t = torch.as_tensor(s, dtype=dt, device=A.device).reshape(1)
    args = [A, rho, d, state, lo, hi, s_t]
    for name, t in zip(("A", "rho", "d", "state", "lo", "hi", "s"), args):
        if t.device != A.device or not t.is_contiguous():
            raise ValueError(f"pricing: {name} must be contiguous on "
                             f"{A.device}")
    if state.dtype != torch.int32:
        raise TypeError("pricing: state must be int32")
    if any(t.dtype != dt for t in (rho, d, lo, hi)):
        raise TypeError("pricing: rho, d, lo, hi must match A's dtype")
    if rho.shape != (m,) or any(t.shape != (N,) for t in (d, state, lo, hi)):
        raise ValueError("pricing: shape mismatch")
    alpha = torch.empty(N, dtype=dt, device=A.device)
    ratio = torch.empty_like(alpha)
    cost = torch.empty_like(alpha)
    lib = _build.load("pricing", _SIG)
    fn = lib.pricing_f64 if dt == torch.float64 else lib.pricing_f32
    err = fn(*(t.data_ptr() for t in args), float(tol), m, N,
             alpha.data_ptr(), ratio.data_ptr(), cost.data_ptr(),
             _build.stream_ptr(A.device))
    _build.check(err, "pricing")
    launches += 1
    return alpha, ratio, cost
