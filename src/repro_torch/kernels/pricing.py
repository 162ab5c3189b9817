"""Fused dual-simplex pricing (paper App. C.3, procedure 1).

Replaces ``repro/kernels/pricing.py::_pricing_kernel`` (Pallas, TPU).
Per pivot the revised dual simplex needs, for every column j of A
(m x N, m tiny)::

    alpha_j = rho . A[:, j]
    ratio_j = max(d_j / (s * alpha_j), 0)  if BFRT-eligible, else +inf
    cost_j  = |alpha_j| * (hi_j - lo_j)    if eligible, else 0

``d`` is the maintained reduced-cost vector, so this is the single O(mN)
sweep of A per pivot.  It also gives the min and max of the finite
ratios, from which the BFRT select builds its bucket edges
(``bfrt.edges_from_range``) without another pass.  On a CUDA tensor a
:class:`Pricer` call launches ``csrc/pricing.cu`` (one thread per column,
rho in shared memory; bound by the bytes of A it reads once — see the
source note); on a CPU tensor it runs :func:`pricing_plain`, which repeats
the kernel's arithmetic in the kernel's order, so the two agree bit for
bit.  The pivot loop makes one :class:`Pricer` per solve, so the loop
constants A, lo and hi are checked once and each pivot's launch path is
a few attribute checks, four pointer stores and one C call.
"""
from __future__ import annotations

import ctypes
import struct

import torch

from repro_torch.kernels import _build

launches = 0

_SIG = {"pricing_f64": (_build.P,), "pricing_f32": (_build.P,)}
_ARGS = 13                   # the C entries' argument words


def ratio_range_plain(ratio):
    """(min, max) of the finite ratios as the kernel writes them: the min is
    NaN without a finite ratio, the max is taken with 0."""
    finite = torch.isfinite(ratio)
    hi = torch.where(finite, ratio, torch.zeros_like(ratio)).max()
    lo = torch.where(finite, ratio, torch.full_like(ratio,
                                                    float("inf"))).min()
    lo = torch.where(torch.isinf(lo), float("nan"), lo)
    return torch.stack([lo, hi])


def pricing_plain(A, rho, d, state, lo, hi, s, tol: float = 1e-9):
    """Plain torch version (any device): same math, same summation order;
    (alpha, ratio, cost, range of the finite ratios)."""
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
    return alpha, ratio, cost, ratio_range_plain(ratio)


class Pricer:
    """Pricing against one solve's loop constants ``A`` (m, N), ``lo`` and
    ``hi`` (N,), checked once here; each call takes the per-pivot inputs.

    ``pricer(rho, d, state, s)`` returns (alpha, ratio, cost, range):
    ``state`` int32 (N,) 0 = nonbasic at lower, 1 = at upper, 2 = basic;
    ``s`` the sign of the primal infeasibility, a one-element tensor (the
    pivot loop's, which keeps it free of host syncs) or a float; ``range``
    the (2,) min and max of the finite ratios (see
    :func:`ratio_range_plain`), None on the kernel's float32 route.

    On CUDA tensors the outputs are views of one buffer that the Pricer
    allocates once and that its next call overwrites (the pivot loop reads
    them within the pivot), and a call checks the per-pivot inputs, stores
    their pointers in the kernel's argument words and launches
    ``csrc/pricing.cu``.  On CPU tensors a call runs
    :func:`pricing_plain` and returns new tensors.
    """

    def __init__(self, A, lo, hi, tol: float = 1e-9):
        self.A, self.lo, self.hi, self.tol = A, lo, hi, float(tol)
        self.cuda = A.device.type == "cuda"
        if not self.cuda:
            return
        dt = A.dtype
        if dt not in (torch.float64, torch.float32):
            raise TypeError(f"pricing kernel takes float32/float64, got {dt}")
        if A.dim() != 2:
            raise ValueError("pricing: A must be (m, N)")
        m, N = A.shape
        for name, t in (("A", A), ("lo", lo), ("hi", hi)):
            if t.device != A.device or not t.is_contiguous():
                raise ValueError(f"pricing: {name} must be contiguous on "
                                 f"{A.device}")
            if t.dtype != dt:
                raise TypeError("pricing: lo, hi must match A's dtype")
        if lo.shape != (N,) or hi.shape != (N,):
            raise ValueError("pricing: shape mismatch")
        lib = _build.load("pricing", _SIG)
        f64 = dt == torch.float64
        self.fn = lib.pricing_f64 if f64 else lib.pricing_f32
        # alpha, ratio, cost; on the float64 route two pairs of range
        # words, which calls take in turn, each launch resetting the next
        # call's pair; the first call's pair starts reset
        self.out = torch.empty(3 * N + 4 * f64, dtype=dt, device=A.device)
        views = self.out[:3 * N].view(3, N).unbind(0)
        if f64:
            self.out[3 * N:].view(torch.int64).copy_(
                torch.tensor([-1, 0, -1, 0]))
            self.views = [(*views, self.out[3 * N + 2 * p:3 * N + 2 * p + 2])
                          for p in (0, 1)]
        else:
            self.views = [(*views, None)] * 2
        self.dt, self.m, self.N = dt, m, N
        self.index = A.device.index
        self.args = (ctypes.c_int64 * _ARGS)(
            A.data_ptr(), 0, 0, 0, lo.data_ptr(), hi.data_ptr(), 0,
            struct.unpack("<q", struct.pack("<d", self.tol))[0], m, N,
            self.out.data_ptr(), 0, 0)

    def _bad(self, t, shape, dtype) -> bool:
        return (t.dtype is not dtype or not t.is_cuda
                or t.get_device() != self.index or not t.is_contiguous()
                or (shape is not None and t.shape != shape))

    def __call__(self, rho, d, state, s):
        global launches
        if not self.cuda:
            return pricing_plain(self.A, rho, d, state, self.lo, self.hi, s,
                                 self.tol)
        dt, m, N = self.dt, self.m, self.N
        if not isinstance(s, torch.Tensor):
            s = torch.as_tensor(s, dtype=dt, device=self.A.device)
        if self._bad(rho, (m,), dt) or self._bad(d, (N,), dt) \
                or self._bad(s, None, dt) or s.numel() != 1:
            raise ValueError(f"pricing: rho ({m},), d ({N},) and s (one "
                             f"value) must be contiguous {dt} on "
                             f"{self.A.device}")
        if self._bad(state, (N,), torch.int32):
            raise TypeError(f"pricing: state must be contiguous int32 "
                            f"({N},) on {self.A.device}")
        args = self.args
        args[1] = rho.data_ptr()
        args[2] = d.data_ptr()
        args[3] = state.data_ptr()
        args[6] = s.data_ptr()
        args[11] = _build.stream_ptr(self.index)
        pair = args[12]
        _build.check(self.fn(args), "pricing")
        args[12] = 1 - pair
        launches += 1
        return self.views[pair]


def pricing(A, rho, d, state, lo, hi, s, tol: float = 1e-9):
    """(alpha, ratio, cost, range) for every column of ``A`` (m, N): one
    :class:`Pricer` made and called, every input checked, new outputs."""
    return Pricer(A, lo, hi, tol)(rho, d, state, s)
