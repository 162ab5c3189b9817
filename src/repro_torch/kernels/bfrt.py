"""BFRT bucketed select (paper App. C.3, procedure 2).

Replaces ``repro/kernels/bfrt.py::_bfrt_hist_kernel`` (Pallas, TPU) and
its two-pass driver ``bfrt_select``.  On a CUDA tensor the whole select
is one hand-written launch (``csrc/bfrt.cu``; three above
``ONE_CTA_MAX`` columns, one more without pricing's ratio range), driven
by a :class:`Selector`:

  edges:  ``NUM_BUCKETS`` upper edges over pricing's ratio range, bit for
     bit :func:`edges_from_range`'s;
  pass 1: per-bucket flip-cost sums of the finite ratios, float64 (the
     TPU kernel used float32), in a fixed order, so two runs agree bit
     for bit;
  pass 2: the crossing bucket, its columns sorted by (ratio, index) and
     walked from the cost before it; the entering column q and the flip
     mask.

On a CPU tensor :func:`bfrt_select_plain` runs the same select in torch
ops.  A crossing bucket of more than ``SELECT_CAP`` columns is refined
by the kernel exactly (:func:`bfrt_select_refined_plain` is that
procedure in torch).  The result is held to the exact sequential rule
(:func:`bfrt_sequential`: sort the eligible columns by ratio, flip while
the cumulative cost stays below the budget, the crossing column enters).
Nothing reads back to the host, so the device LP's pivot stays free of
syncs here.  :func:`bfrt_histogram` is pass 1 alone, on its own kernel.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

NUM_BUCKETS = 128
ONE_CTA_MAX = 8192       # csrc/bfrt.cu ONE_MAX: one launch up to this N
SELECT_CAP = 8192        # csrc/bfrt.cu CAP: bucket columns sorted at once
launches = 0

_SIG = {"bfrt_hist_f64": (_build.P, _build.P, _build.P, _build.I64,
                          _build.I64) + (_build.P,) * 5,
        "bfrt_hist_nblocks": (_build.I64,),
        "bfrt_select_f64": (_build.P,), "bfrt_select_init": (),
        "bfrt_select_work_bytes": (_build.I64,),
        "bfrt_select_limits": (_build.P,)}
_ARGS = 11               # bfrt_select_f64's argument words


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


_STEPS = {}                  # (num_buckets, dtype, device) -> steps


def edges_from_range(rng, num_buckets: int = NUM_BUCKETS):
    """:func:`bucket_edges` from the (2,) min and max of the finite ratios
    that pricing writes (``pricing.ratio_range_plain``), bit for bit: the
    same operations on the same two numbers, the +inf edge from a last
    step of +inf."""
    key = (num_buckets, rng.dtype, rng.device)
    steps = _STEPS.get(key)
    if steps is None:
        steps = _STEPS[key] = torch.cat([
            torch.arange(1, num_buckets, dtype=rng.dtype, device=rng.device)
            / (num_buckets - 1),
            torch.full((1,), float("inf"), dtype=rng.dtype,
                       device=rng.device)])
    rmin = torch.fmin(rng[:1], rng[1:])
    return rmin + torch.clamp_min(rng[1:] - rmin, 1e-12) * steps


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


def _bucket(ratio, cost, budget, num_buckets, rng):
    """Pass 1 and the crossing bucket in torch ops: (budget as a
    1-element tensor, finite mask, has_cross, the mask of the crossing
    bucket's columns, the cost of the buckets before it)."""
    dt = ratio.dtype
    dev = ratio.device
    budget = torch.as_tensor(budget, dtype=dt, device=dev).reshape(1)
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    finite = torch.isfinite(ratio)
    any_elig = finite.any()
    zero = torch.zeros((), dtype=dt, device=dev)
    edges = bucket_edges(ratio, num_buckets) if rng is None \
        else edges_from_range(rng, num_buckets)
    sums, _ = bfrt_histogram_plain(ratio, cost, edges)
    csum = torch.cumsum(sums, 0)
    crossed = csum >= budget - 1e-12
    bidx = _first_true(crossed)
    has_cross = crossed.any()
    prev = torch.clamp_min(bidx - 1, 0)
    lo_edge = torch.where(bidx == 0, -inf, edges[prev])
    hi_edge = edges[bidx]
    base = torch.where(bidx == 0, zero, csum[prev])
    in_bucket = (ratio > lo_edge) & (ratio <= hi_edge) & finite
    return budget, finite, has_cross & any_elig, in_bucket, base


def bfrt_select_plain(ratio, cost, budget, *,
                      num_buckets: int = NUM_BUCKETS, rng=None):
    """The select in torch ops, on any device: (q, flip mask, has_cross),
    q and has_cross 0-d.  ``budget`` is a float or a 1-element tensor;
    ``rng``, the finite ratios' range from pricing, spares the pass that
    finds it.  Ineligible columns carry ratio = +inf and cost = 0 (pricing
    output)."""
    dt = ratio.dtype
    dev = ratio.device
    N = ratio.shape[0]
    budget, finite, has_cross, in_bucket, base = _bucket(
        ratio, cost, budget, num_buckets, rng)
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    # pass 2: exact walk inside the crossing bucket (stable sort)
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
    return q.reshape(()), flips, has_cross


def _order_keys(ratio):
    """The kernel's 64-bit order key of each ratio (-0 taken as +0), as an
    int64 that orders like it: the key's bits with the top one flipped."""
    bits = (ratio + 0.0).view(torch.int64)
    return bits ^ ((bits >> 63) & 0x7FFF_FFFF_FFFF_FFFF)


def bfrt_select_refined_plain(ratio, cost, budget, *, rng=None,
                              cap: int = SELECT_CAP):
    """The kernel's select in torch ops, its crowded-bucket refinement
    included: a crossing bucket of more than ``cap`` columns is narrowed
    by radix levels over the 96-bit key (order key of the ratio, column
    index).  Each level takes the 8-bit digit holding the highest bit where
    the candidates' smallest and largest keys differ, sums the costs per
    digit, keeps the digit whose running sum from ``base`` reaches the
    threshold and moves ``base`` past the digits before it; at most
    ``cap`` columns are then sorted and walked.  Where no digit or column
    reaches the threshold (rounding), the bucket's first column enters, as
    in :func:`bfrt_select_plain`.  Returns what :func:`bfrt_select_plain`
    returns; the sums are taken in another order than the kernel's."""
    budget, finite, has_cross, cand, base = _bucket(
        ratio, cost, budget, NUM_BUCKETS, rng)
    in_bucket = cand
    count = int(cand.sum())
    if count <= cap:
        return bfrt_select_plain(ratio, cost, budget, rng=rng)
    thr = float(budget - 1e-12)
    base = float(base)
    dev = ratio.device
    sk = _order_keys(ratio)
    idx = torch.arange(ratio.shape[0], dtype=torch.int64, device=dev)

    def key(s, i):                    # the 96-bit key as a Python int
        return ((int(s) + 2 ** 63) << 32) | int(i)

    def split(K):                     # (signed high word, index)
        return (K >> 32) - 2 ** 63, K & 0xFFFF_FFFF

    def within(KL, KH):
        (ls, li), (hs, hi) = split(KL), split(KH)
        return (((sk > ls) | ((sk == ls) & (idx >= li)))
                & ((sk < hs) | ((sk == hs) & (idx <= hi))))

    first = None
    while count > cap:
        s_c, i_c = sk[cand], idx[cand]
        mn = key(s_c.min(), i_c[s_c == s_c.min()].min())
        mx = key(s_c.max(), i_c[s_c == s_c.max()].max())
        if first is None:
            first = mn & 0xFFFF_FFFF
        sh = ((mn ^ mx).bit_length() - 1) & ~7
        if sh >= 32:
            digit = ((sk >> (sh - 32)) & 255) ^ (128 if sh == 88 else 0)
        else:
            digit = (idx >> sh) & 255
        sums = torch.zeros(256, dtype=ratio.dtype, device=dev).index_add_(
            0, digit[cand], cost[cand]).tolist()
        cs, prev, d = 0.0, 0.0, None
        for b in range(256):
            cs += sums[b]
            if base + cs >= thr:
                d = b
                break
            prev = cs
        if d is None:
            return _refined_result(ratio, finite, in_bucket, first,
                                   has_cross)
        if d > 0:
            base = base + prev
        KL = (mn >> (sh + 8) << (sh + 8)) | (d << sh)
        KH = KL | ((1 << sh) - 1)
        cand = cand & within(KL, KH)
        count = int(cand.sum())
    order = torch.sort(torch.where(cand, ratio, float("inf")),
                       stable=True).indices[:count]
    run = torch.cumsum(cost[order], 0).tolist()
    pos = next((p for p, c in enumerate(run) if base + c >= thr), None)
    q = first if pos is None else int(order[pos])
    return _refined_result(ratio, finite, in_bucket, q, has_cross)


def _refined_result(ratio, finite, in_bucket, q, has_cross):
    """(q, flip mask, has_cross) as the kernel writes them for an entering
    column q of the crossing bucket ``in_bucket``."""
    iN = torch.arange(ratio.shape[0], dtype=torch.int64, device=ratio.device)
    rq = ratio[q]
    flips = finite & ((ratio < rq) | (in_bucket & (ratio == rq) & (iN < q)))
    q = torch.tensor(q, dtype=torch.int64, device=ratio.device)
    return q, flips & (iN != q), has_cross


class Selector:
    """The BFRT select of one solve's pivots, over ``N`` columns on
    ``device``: made once beside the pivot loop's ``Pricer``, called once a
    pivot.

    ``selector(ratio, cost, budget, rng=None)`` returns (q, flip mask,
    has_cross), q int64 and has_cross bool of shape (1,) (the pivot loop
    indexes with them: never a 0-d index, which torch turns into a host
    sync).  ``ratio`` and ``cost`` are (N,) float64, ``budget`` a float or a
    1-element float64 tensor, ``rng`` pricing's (2,) range of the finite
    ratios or None.

    On CUDA tensors the outputs are the Selector's own buffers, which its
    next call overwrites, and a call checks its inputs, stores their
    pointers in the kernel's argument words and makes one C call: one
    launch of ``csrc/bfrt.cu`` for N <= ``ONE_CTA_MAX``, three above, one
    more without ``rng``; no host sync.  On CPU tensors a call runs
    :func:`bfrt_select_plain` and returns new tensors.
    """

    def __init__(self, N: int, device, num_buckets: int = NUM_BUCKETS):
        self.N, self.num_buckets = int(N), num_buckets
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if not 1 <= self.N < 2 ** 31:
            raise ValueError(f"bfrt select: N = {self.N} columns is out of "
                             f"range [1, 2^31)")
        if not self.cuda:
            return
        if num_buckets != NUM_BUCKETS:
            raise ValueError(f"the select kernel takes {NUM_BUCKETS} "
                             f"buckets, not {num_buckets}")
        lib = _build.load("bfrt", _SIG)
        limits = (ctypes.c_int64 * 3)()
        lib.bfrt_select_limits(limits)
        if tuple(limits) != (ONE_CTA_MAX, SELECT_CAP, NUM_BUCKETS):
            raise RuntimeError("csrc/bfrt.cu and kernels/bfrt.py disagree on "
                               f"the select's limits: {tuple(limits)}")
        _build.check(lib.bfrt_select_init(), "bfrt_select")
        self.fn = lib.bfrt_select_f64
        dev = self.device
        self.q = torch.zeros(1, dtype=torch.int64, device=dev)
        self.has_cross = torch.zeros(1, dtype=torch.bool, device=dev)
        self.flips = torch.zeros(self.N, dtype=torch.bool, device=dev)
        self.rng = torch.zeros(2, dtype=torch.float64, device=dev)
        # the grid path's scratch; its two ticket words start at 0 and
        # every call leaves them so
        self.work = torch.zeros(max(lib.bfrt_select_work_bytes(self.N), 1),
                                dtype=torch.uint8, device=dev)
        self.index = self.q.get_device()
        self.per_call = 1 if self.N <= ONE_CTA_MAX else 3
        self.args = (ctypes.c_int64 * _ARGS)(
            0, 0, 0, 0, self.N, self.q.data_ptr(), self.flips.data_ptr(),
            self.has_cross.data_ptr(), self.work.data_ptr(), 0,
            self.rng.data_ptr())

    def _bad(self, t, n: int, vector: bool = True) -> bool:
        return (not isinstance(t, torch.Tensor)
                or t.dtype is not torch.float64 or t.is_cuda is not self.cuda
                or (self.cuda and t.get_device() != self.index)
                or not t.is_contiguous() or t.numel() != n
                or (vector and t.dim() != 1))

    def __call__(self, ratio, cost, budget, rng=None):
        global launches
        N = self.N
        if self._bad(ratio, N) or self._bad(cost, N):
            raise ValueError(f"bfrt select: ratio and cost must be "
                             f"contiguous float64 ({N},) on {self.device}")
        if rng is not None and self._bad(rng, 2):
            raise ValueError(f"bfrt select: rng must be a contiguous float64 "
                             f"(2,) on {self.device}")
        if isinstance(budget, torch.Tensor):
            if self._bad(budget, 1, vector=False):
                raise ValueError(f"bfrt select: budget must be one float64 "
                                 f"value on {self.device}")
        elif self.cuda:
            budget = torch.as_tensor(float(budget), dtype=torch.float64,
                                     device=self.device)
        if not self.cuda:
            q, flips, has_cross = bfrt_select_plain(
                ratio, cost, budget, num_buckets=self.num_buckets, rng=rng)
            return q.reshape(1), flips, has_cross.reshape(1)
        args = self.args
        args[0] = ratio.data_ptr()
        args[1] = cost.data_ptr()
        args[2] = 0 if rng is None else rng.data_ptr()
        args[3] = budget.data_ptr()
        args[9] = _build.stream_ptr(self.index)
        _build.check(self.fn(args), "bfrt_select")
        launches += self.per_call + (rng is None)
        return self.q, self.flips, self.has_cross


def bfrt_select(ratio, cost, budget, *, num_buckets: int = NUM_BUCKETS,
                rng=None):
    """The BFRT select: (entering index q, flip mask, has_cross), all on
    ``ratio``'s device, q and has_cross 0-d, new tensors.  A CUDA tensor
    goes through a :class:`Selector` made for this call (the kernel);
    a CPU tensor through :func:`bfrt_select_plain`."""
    if ratio.device.type != "cuda":
        return bfrt_select_plain(ratio, cost, budget,
                                 num_buckets=num_buckets, rng=rng)
    q, flips, has_cross = Selector(ratio.numel(), ratio.device,
                                   num_buckets)(ratio, cost, budget, rng)
    return q.reshape(()), flips, has_cross.reshape(())
