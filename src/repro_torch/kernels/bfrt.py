"""BFRT bucketed select (paper App. C.3, procedure 2).

Replaces ``repro/kernels/bfrt.py::_bfrt_hist_kernel`` (Pallas, TPU) and
ports its two-pass select ``bfrt_select``:

  pass 1 (:func:`bfrt_histogram`, the kernel ``csrc/bfrt.cu``): per-bucket
     flip-cost sums and counts of the finite ratios over NB ascending upper
     edges (last = +inf), accumulated in float64 (the TPU kernel used
     float32) with a fixed summation order, so two runs agree bit for bit;
  pass 2 (plain torch on the tensor's device): cumsum over the buckets,
     the crossing bucket, an exact stable sort inside it, the entering
     column q and the flip mask.

The result is held to the exact sequential rule (sort eligible columns by
ratio, flip while the cumulative cost stays below the budget, the
crossing column enters).  Pass 2 needs no host sync, so the device LP
reads nothing back here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

NUM_BUCKETS = 128
launches = 0

_SIG = {"bfrt_hist_f64": (_build.P, _build.P, _build.P, _build.I64,
                          _build.I64) + (_build.P,) * 5,
        "bfrt_hist_nblocks": (_build.I64,)}


def bfrt_histogram_plain(ratio, cost, edges):
    """Plain torch pass 1: (sums, counts) per bucket, float64."""
    finite = torch.isfinite(ratio)
    nb = edges.shape[0]
    bucket = torch.searchsorted(edges, torch.where(finite, ratio,
                                                   edges[0]), right=False)
    bucket = bucket.clamp(0, nb - 1)
    w = finite.to(ratio.dtype)
    sums = torch.zeros(nb, dtype=ratio.dtype, device=ratio.device)
    counts = torch.zeros(nb, dtype=ratio.dtype, device=ratio.device)
    sums.index_add_(0, bucket, torch.where(finite, cost,
                                           torch.zeros_like(cost)))
    counts.index_add_(0, bucket, w)
    return sums, counts


def bfrt_histogram(ratio, cost, edges):
    """Pass 1: per-bucket flip-cost sums and counts of finite ratios.

    ratio/cost: (N,) float64; edges: (NB,) ascending upper edges with
    edges[-1] = +inf.  CUDA tensors launch the kernel, CPU tensors run
    :func:`bfrt_histogram_plain`.
    """
    global launches
    if ratio.device.type != "cuda":
        return bfrt_histogram_plain(ratio, cost, edges)
    for name, t in (("ratio", ratio), ("cost", cost), ("edges", edges)):
        if t.dtype != torch.float64 or t.device != ratio.device \
                or not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f"bfrt_histogram: {name} must be a contiguous "
                             f"1-d float64 tensor on {ratio.device}")
    N, nb = ratio.shape[0], edges.shape[0]
    if cost.shape[0] != N or not 1 <= nb <= 1024:
        raise ValueError("bfrt_histogram: shape mismatch or NB > 1024")
    lib = _build.load("bfrt", _SIG)
    nblocks = lib.bfrt_hist_nblocks(N)
    dev = ratio.device
    part = torch.empty((2, nblocks, nb), dtype=torch.float64, device=dev)
    out = torch.empty((2, nb), dtype=torch.float64, device=dev)
    err = lib.bfrt_hist_f64(ratio.data_ptr(), cost.data_ptr(),
                            edges.data_ptr(), N, nb, part[0].data_ptr(),
                            part[1].data_ptr(), out[0].data_ptr(),
                            out[1].data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "bfrt_histogram")
    launches += 1
    return out[0], out[1]


def _first_true(mask):
    """Index of the first True (0 if none) as a 1-element tensor.  Every
    index in this module is a 1-element tensor, never a 0-d one: torch
    turns a 0-d index into a Python int, a host sync."""
    return torch.argmax(mask.to(torch.int32)).reshape(1)


def bucket_edges(ratio, num_buckets: int = NUM_BUCKETS):
    """The ``num_buckets`` ascending upper edges of pass 1: evenly spaced
    over the finite ratios' range, the last one +inf."""
    dt, dev = ratio.dtype, ratio.device
    finite = torch.isfinite(ratio)
    zero = torch.zeros((), dtype=dt, device=dev)
    rmax = torch.where(finite, ratio, zero).max()
    rmin = torch.where(finite, ratio, rmax).min()
    span = torch.clamp_min(rmax - rmin, 1e-12)
    steps = torch.arange(1, num_buckets, dtype=dt, device=dev) \
        / (num_buckets - 1)
    inf = torch.full((1,), float("inf"), dtype=dt, device=dev)
    return torch.cat([rmin + span * steps, inf])


def bfrt_sequential(ratio: np.ndarray, cost: np.ndarray, budget: float):
    """The exact sequential rule (numpy): sort the finite ratios stably,
    flip while the cumulative cost stays below the budget; the crossing
    column enters.  Returns (q, flip mask, has_cross); q = -1 without a
    crossing."""
    ratio = np.asarray(ratio)
    cost = np.asarray(cost)
    finite = np.isfinite(ratio)
    order = np.argsort(ratio, kind="stable")
    order = order[finite[order]]
    csum = np.cumsum(cost[order])
    cross = int(np.searchsorted(csum, budget - 1e-12))
    if cross >= len(order):
        return -1, np.zeros_like(finite), False
    flips = np.zeros_like(finite)
    flips[order[:cross]] = True
    return int(order[cross]), flips, True


def bfrt_select(ratio, cost, budget, *, num_buckets: int = NUM_BUCKETS):
    """Two-pass BFRT: (entering index q, flip mask, has_cross), all as
    tensors on ``ratio``'s device (q and has_cross 0-d), with no host
    sync.  ``budget`` may be a float or a 1-element tensor.

    Ineligible columns carry ratio = +inf and cost = 0 (pricing output).
    """
    dt = ratio.dtype
    dev = ratio.device
    N = ratio.shape[0]
    budget = torch.as_tensor(budget, dtype=dt, device=dev).reshape(1)
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    finite = torch.isfinite(ratio)
    any_elig = finite.any()
    zero = torch.zeros((), dtype=dt, device=dev)
    edges = bucket_edges(ratio, num_buckets)
    sums, _ = bfrt_histogram(ratio, cost, edges)
    csum = torch.cumsum(sums, 0)
    crossed = csum >= budget - 1e-12
    bidx = _first_true(crossed)
    has_cross = crossed.any()
    prev = torch.clamp_min(bidx - 1, 0)
    lo_edge = torch.where(bidx == 0, -inf, edges[prev])
    hi_edge = edges[bidx]
    base = torch.where(bidx == 0, zero, csum[prev])

    # pass 2: exact walk inside the crossing bucket (stable sort)
    in_bucket = (ratio > lo_edge) & (ratio <= hi_edge) & finite
    r_in = torch.where(in_bucket, ratio, inf)
    order = torch.sort(r_in, stable=True).indices
    fin_sorted = torch.isfinite(r_in[order])
    cost_sorted = torch.where(fin_sorted, cost[order], zero)
    csum_in = base + torch.cumsum(cost_sorted, 0)
    q = order[_first_true((csum_in >= budget - 1e-12) & fin_sorted)]
    rank = torch.empty_like(order)
    iN = torch.arange(N, dtype=torch.int64, device=dev)
    rank[order] = iN
    flips = finite & ((ratio < ratio[q]) | (in_bucket & (rank < rank[q])))
    flips = flips & (iN != q)
    return q.reshape(()), flips, has_cross & any_elig
