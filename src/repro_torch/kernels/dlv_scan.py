"""DLV Algorithm-5 cut scan over many concatenated sorted segments.

Replaces the jitted JAX scan ``repro/core/dlv.py::_dlv_scan_cols`` (the
TPU branch of ``_seg_cuts``).  ``vals`` holds the segments back to back,
each sorted ascending and centred on its own mean, with lengths ``Ls`` and
split bars ``beta``; the result flags every row before which a delimiter
is placed (before snapping to equal-value run starts, which the caller
does).

On a CUDA tensor :func:`dlv_scan` launches ``csrc/dlv_scan.cu``, which
places the Kahan-compensated float64 scan's cuts (built without FMA
contraction) by one of two paths, chosen per segment by length:

* segments shorter than ``LONG_MIN`` rows: one thread per segment, the
  compensated row steps in order;
* longer ones: one CTA per segment that speculates cuts in parallel with
  a division-free test, verifies every speculative window with the
  compensated steps, and repairs the first wrong one (see the source
  note).  :func:`long_scan_plain` is that loop in plain torch, for the
  tests; the main path never runs it.

Both paths give the compensated scan's cuts bit for bit.  On a CPU tensor
:func:`dlv_scan` runs :func:`dlv_scan_plain`, the reference's float64 host
path in torch: segments grouped by length, wide groups through the
compensated column row-step scan (the kernel's arithmetic, bit for bit),
narrow groups and long segments through the exact cut-to-cut jump scan
(same cut rule, prefix-sum rounding).

So for narrow groups and single long segments the kernel and the plain
version do two kinds of arithmetic: compensated running sums against
uncompensated prefix sums over the window since the last cut.  They place
the same cuts unless a running variance lies within rounding of ``beta``;
on such data a CPU build and a CUDA build can cut differently.
:func:`scan_cols_plain` is the kernel's arithmetic step for step, and is
what tells a kernel fault from a rounding-order difference.

:func:`dlv_scan_seed` is the seed's scan, for one span: the
uncompensated running-variance recurrence of the jitted ``lax.scan``
``repro/core/dlv.py::_dlv_scan_seed`` (no run snapping, no ``k > 0``
guard).  The reference's compiled scan (XLA on the CPU) computes var =
s2/k - m*m as one fused multiply-add and rounds every other operation on
its own; every version here decides each row as it does, and their cuts
equal the reference's bit for bit, at near-ties too.  On a CPU tensor it
runs :func:`dlv_scan_seed_plain`, the recurrence in Python floats.  On a
CUDA tensor it launches four kernels of ``csrc/dlv_scan.cu`` (one count
in ``seed_launches`` a call).  What bounds the work is 9 bytes a row; the
recurrence, walked in order, is a chain of two divisions and an FMA a
row, which is what the design takes off the path:

* the restart state at a cut, (1, x, x*x), is the state of a scan
  started fresh there, so each window between cuts is decided on its
  own: var_ref(j, i), the reference's value at row i of the window from
  j, depends on j and i alone;
* double-double prefix sums of x and x*x over the span (every SM, a
  fixed order of additions) give each window's sums as a difference,
  and k*s2 - s1*s1 estimates k^2 var_ref(j, i) within a band W that
  bounds the serial chain's rounding (|s1^ - S1| <= g_{k-1} sum|x|,
  |s2^ - S2| <= g_k S2, two divisions, one fused rounding; sum|x| <=
  sqrt(k S2)), the prefixes' own error and the evaluation's (the proof is
  the source note; :func:`_seed_band_terms` is its arithmetic);
* one CTA walks the windows, each test taking 256 rows one by one and
  256 blocks of 128 rows after them; a block is proved below beta from its
  last row's prefix alone (k * variance, the window's sum of squared
  deviations, never decreases); the first block not proved below has its
  rows tested next, and the first row not surely below is a cut where
  the band proves it; otherwise (a near-tie, a non-finite sum, band or
  beta), and for the windows after a short one, one thread runs the
  reference's chain from the window start.

So a row is decided by the band only where the band proves the
reference's decision; the cuts do not depend on the span being sorted.
:func:`seed_scan_certified_plain` is that design in plain torch (same
tiles, band, order of additions and fallback, same counters) for the
CPU tests; the main path never runs it.  ``serial=True`` launches the
kernel the design replaced (one thread walks the span), kept as its
baseline.
"""
from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

from repro_torch.kernels import _build

launches = 0
seed_launches = 0            # dlv_scan_seed's calls (four kernels each)
seed_serial_launches = 0     # dlv_scan_seed(..., serial=True)'s kernel

_BATCH_MIN_COLS = 16         # below this, per-segment jump scan wins
_MAX_COLS = 1024             # row-step width cap

# segments of at least LONG_MIN rows take the long path (one CTA each);
# chosen on the card by chip_smoke.py's "dlv_scan threshold" sweep
LONG_MIN = 4096
TILE = 8192                  # the long path's speculation tile (rows)
SPEC_CAP = 4096              # speculative cuts per pass
# the long path's counters (``dlv_scan(..., stats=True)``), in this order:
# sums over the call's long segments (cycles are each CTA's thread 0's:
# speculating, of that waiting for tiles and moving and scanning them,
# verifying), except the longest verified window, a maximum
STAT_NAMES = ("segments", "passes", "spec_cuts", "windows", "repairs",
              "spec_cycles", "verify_cycles", "tiles", "wait_cycles",
              "scan_cycles", "longest_window")

_SIG = {"dlv_scan_f64": (_build.P,) * 4 + (_build.I64, _build.P, _build.P),
        "dlv_scan_long_f64": (_build.P,) * 4 + (_build.I64,) + (_build.P,) * 2
        + (_build.I64, _build.P, _build.P),
        "dlv_scan_seed_f64": (_build.P, _build.I64, _build.F64)
        + (_build.P,) * 4,
        "dlv_scan_seed_serial_f64": (_build.P, _build.I64, _build.F64,
                                     _build.P, _build.P)}


def _starts(Ls: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(Ls)[:-1]]).astype(np.int64)


def scan_cols_plain(V, B):
    """Compensated row-step scan of the columns of ``V`` (rows, cols), each
    an independent segment with bar ``B[col]`` (the reference's
    ``_scan_cols_np``, operation for operation)."""
    C, m = V.shape
    z = torch.zeros(m, dtype=torch.float64, device=V.device)
    k, s1, c1, s2, c2 = z, z, z, z, z
    one = torch.ones_like(z)
    cuts = torch.zeros((C, m), dtype=torch.bool, device=V.device)
    for i in range(C):
        x = V[i]
        k1 = k + 1.0
        x2 = x * x
        y1 = x - c1
        t1 = s1 + y1
        c1n = (t1 - s1) - y1
        y2 = x2 - c2
        t2 = s2 + y2
        c2n = (t2 - s2) - y2
        mean = t1 / k1
        var = t2 / k1 - mean * mean
        cut = (var > B) & (k > 0)
        cuts[i] = cut
        k = torch.where(cut, one, k1)
        s1 = torch.where(cut, x, t1)
        c1 = torch.where(cut, z, c1n)
        s2 = torch.where(cut, x2, t2)
        c2 = torch.where(cut, z, c2n)
    return cuts


def jump_scan_plain(v, beta: float):
    """Exact Algorithm-5 scan of ONE segment via cut-to-cut jumps: from
    each cut, prefix sums over a growing window give the running variance
    at every candidate row (the reference's ``_jump_scan_np``)."""
    n = len(v)
    cuts = torch.zeros(n, dtype=torch.bool, device=v.device)
    s = 0
    jump = 256
    while s < n:
        W = max(64, 4 * jump)
        found = -1
        while True:
            e = min(s + W, n)
            w = v[s:e]
            kk = torch.arange(1, e - s + 1, dtype=torch.float64,
                              device=v.device)
            S1 = torch.cumsum(w, 0)
            S2 = torch.cumsum(w * w, 0)
            mean = S1 / kk
            hit = S2 / kk - mean * mean > beta
            hit[0] = False                # a run's first element never cuts
            first = int(torch.argmax(hit.to(torch.int32)))
            if bool(hit[first]):
                found = s + first
                break
            if e >= n:
                break
            W *= 4
        if found < 0:
            break
        cuts[found] = True
        jump = max(found - s, 1)
        s = found
    return cuts


def _first_hits(v, a, e, beta: float, max_elems: int = 1 << 22):
    """For each window (a[j], e[j]] of the segment ``v``: the first row at
    which the compensated scan started fresh at row a[j] cuts, or -1
    (``scan_cols_plain`` over the windows as columns, grouped by
    length)."""
    a = np.asarray(a, np.int64)
    e = np.asarray(e, np.int64)
    out = np.full(len(a), -1, np.int64)
    length = e - a + 1
    order = np.argsort(length, kind="stable")
    i = 0
    while i < len(order):
        j = i + 1
        while j < len(order) and length[order[j]] * (j + 1 - i) <= max_elems:
            j += 1
        sub = order[i:j]
        i = j
        ln = torch.as_tensor(length[sub], device=v.device)
        st = torch.as_tensor(a[sub], device=v.device)
        ridx = torch.arange(int(length[sub].max()), device=v.device)[:, None]
        V = v[st[None, :] + torch.minimum(ridx, ln[None, :] - 1)]
        bars = torch.full((len(sub),), beta, dtype=torch.float64,
                          device=v.device)
        hit = (scan_cols_plain(V, bars) & (ridx < ln[None, :])).cpu()
        anyhit = hit.any(0).numpy()
        first = torch.argmax(hit.to(torch.int32), 0).numpy()
        out[sub] = np.where(anyhit, a[sub] + first, -1)
    return out


def _speculate_plain(v, beta: float, w: int, lo: int, tile: int, cap: int):
    """The long path's speculation from window start ``w`` (hits allowed
    from row ``lo``): tiles of ``tile`` rows, prefix sums of x - u with u
    the tile's first value, a carry from the window start moved to each
    tile's shift, and the division-free test k*S2 - S1^2 > beta*k^2.
    Returns (speculative cuts, whether the walk reached the end)."""
    L = len(v)
    out = []
    D = Q = kc = uprev = 0.0
    first = True
    t = w // tile
    while t * tile < L:
        ts = t * tile
        x = v[ts:ts + tile]
        u = float(x[0])
        d = x - u
        P1 = torch.cumsum(d, 0)
        P2 = torch.cumsum(d * d, 0)
        rows = torch.arange(ts, ts + len(x), device=v.device)
        if first:
            first = False
            D = Q = kc = 0.0
            B1 = float(P1[w - ts - 1]) if w > ts else 0.0
            B2 = float(P2[w - ts - 1]) if w > ts else 0.0
        else:
            dl = u - uprev
            Q = Q - 2.0 * dl * D + kc * dl * dl
            D = D - kc * dl
            B1 = B2 = 0.0
        while True:
            k = (rows - w + 1).to(torch.float64)
            S1 = D + P1 - B1
            S2 = Q + P2 - B2
            hit = (rows >= lo) & (k * S2 - S1 * S1 > beta * (k * k))
            if not bool(hit.any()):
                break
            h = int(torch.argmax(hit.to(torch.int32)))
            out.append(ts + h)
            B1 = float(P1[h - 1]) if h else 0.0
            B2 = float(P2[h - 1]) if h else 0.0
            D = Q = 0.0
            w, lo = ts + h, ts + h + 1
            if len(out) == cap:
                return out, False
        if w >= ts:
            D, Q = float(P1[-1]) - B1, float(P2[-1]) - B2
        else:
            D, Q = D + float(P1[-1]), Q + float(P2[-1])
        kc = float(ts + tile - w)
        uprev = u
        t += 1
    return out, True


def long_scan_plain(v, beta: float, *, spec=None, tile: int = TILE,
                    cap: int = SPEC_CAP, stats: dict = None):
    """The long path of ``csrc/dlv_scan.cu`` in plain torch, for ONE
    segment ``v``: speculate, verify every window with the compensated
    steps, repair at the first wrong window, until the walk is verified to
    the end.  ``spec`` (sorted rows in [1, len(v))) replaces the first
    pass's speculation, as the kernel's ``init_spec`` does; ``stats``
    (a dict) receives the counts of ``STAT_NAMES`` that a CPU run has.
    Returns the compensated scan's cut flags."""
    L = len(v)
    cuts = torch.zeros(L, dtype=torch.bool, device=v.device)
    count = dict.fromkeys(("passes", "spec_cuts", "windows", "repairs"), 0)
    w, lo = 0, 1
    while True:
        count["passes"] += 1
        if count["passes"] > 2 * L + 4:
            raise RuntimeError("long_scan_plain: repairs did not advance")
        if spec is not None:
            sp, ended = [int(s) for s in spec], True
            spec = None
        else:
            sp, ended = _speculate_plain(v, beta, w, lo, tile, cap)
        n = len(sp)
        nw = n + 1 if ended else n
        a = [w] + sp[:nw - 1]
        e = sp[:n] + ([L - 1] if ended else [])
        f = _first_hits(v, a, e, beta)
        bad = [j for j in range(nw)
               if (f[j] != e[j] if j < n else f[j] >= 0)]
        count["spec_cuts"] += n
        count["windows"] += nw
        ok = bad[0] if bad else n
        cuts[torch.as_tensor(sp[:ok], dtype=torch.int64)] = True
        if not bad:
            if ended:
                break
            w, lo = sp[-1], sp[-1] + 1
            continue
        count["repairs"] += 1
        jb = bad[0]
        if f[jb] >= 0:
            cuts[int(f[jb])] = True
            w, lo = int(f[jb]), int(f[jb]) + 1
        else:
            w, lo = a[jb], sp[jb] + 1
    if stats is not None:
        stats.update(count)
    return cuts


def _batch_cols(cuts, vals, starts, Ls, beta, sub) -> None:
    dev = vals.device
    st = torch.as_tensor(starts[sub], dtype=torch.int64, device=dev)
    ln = torch.as_tensor(Ls[sub], dtype=torch.int64, device=dev)
    ridx = torch.arange(int(Ls[sub].max()), dtype=torch.int64,
                        device=dev)[:, None]
    gather = st[None, :] + torch.minimum(ridx, ln[None, :] - 1)
    out = scan_cols_plain(vals[gather],
                          torch.as_tensor(beta[sub], dtype=torch.float64,
                                          device=dev))
    valid = ridx < ln[None, :]
    cuts[(st[None, :] + ridx)[valid]] = out[valid]


def dlv_scan_plain(vals, Ls, beta, *, pitch: int = 256):
    """Plain torch version: the reference host path of ``_seg_cuts``
    (length groups; row-step scan when wide, jump scan otherwise -- the
    latter rounds unlike the kernel, see the module note)."""
    Ls = np.asarray(Ls, np.int64)
    beta = np.asarray(beta, np.float64)
    starts = _starts(Ls)
    cuts = torch.zeros(len(vals), dtype=torch.bool, device=vals.device)
    ord_len = np.argsort(Ls, kind="stable")
    i = 0
    while i < len(ord_len):
        L0 = int(Ls[ord_len[i]])
        j = i + 1
        while (j < len(ord_len) and j - i < _MAX_COLS
               and Ls[ord_len[j]] <= max(2 * L0, L0 + 64)):
            j += 1
        group = ord_len[i:j]
        i = j
        cols = len(group)
        # jump cost ~ cols*rows/pitch window ops; row scan ~ rows steps
        if cols < _BATCH_MIN_COLS or cols < max(1, pitch) // 2:
            for s in group:
                a, L = int(starts[s]), int(Ls[s])
                if L:
                    cuts[a:a + L] = jump_scan_plain(vals[a:a + L],
                                                    float(beta[s]))
        else:
            _batch_cols(cuts, vals, starts, Ls, beta, group)
    return cuts


def _check_vals(vals) -> None:
    if vals.dtype != torch.float64 or vals.dim() != 1 \
            or not vals.is_contiguous():
        raise ValueError("dlv_scan: vals must be a contiguous 1-d float64 "
                         "tensor")


def _aligned(vals):
    """``vals`` at a 16-byte aligned address (a copy if a view is not):
    the long path's bulk copies read from the aligned row at or before a
    tile's first, which for row 0 must be row 0 itself."""
    return vals if vals.data_ptr() % 16 == 0 else vals.clone()


def dlv_scan(vals, Ls, beta, *, pitch: int = 256, stats: bool = False):
    """Cut flags (bool, like ``vals``) for the segments of ``vals``.

    ``Ls`` (segment lengths, summing to ``len(vals)``) and ``beta``
    (per-segment bars) are host arrays; ``pitch`` (the expected distance
    between cuts) only steers the plain version's choice of scan.  On a
    CUDA tensor segments of at least ``LONG_MIN`` rows (read at the call)
    take the long path;
    one call is one launch in ``launches`` whatever it starts.  With
    ``stats`` the result is (cuts, the long path's counters: an int64
    device tensor in ``STAT_NAMES`` order, zeros on the CPU).
    """
    global launches
    if vals.device.type != "cuda":
        cuts = dlv_scan_plain(vals, Ls, beta, pitch=pitch)
        return (cuts, torch.zeros(len(STAT_NAMES), dtype=torch.int64)) \
            if stats else cuts
    _check_vals(vals)
    vals = _aligned(vals)
    Ls = np.asarray(Ls, np.int64)
    beta = np.asarray(beta, np.float64)
    n = len(vals)
    if int(Ls.sum()) != n or len(beta) != len(Ls):
        raise ValueError("dlv_scan: segment lengths must sum to len(vals) "
                         "and match beta")
    if len(Ls) and int(Ls.max()) >= 1 << 31:
        raise ValueError("dlv_scan: a segment of 2^31 rows or more")
    dev = vals.device
    st = torch.zeros(len(STAT_NAMES), dtype=torch.int64, device=dev) \
        if stats else None
    long = Ls >= max(int(LONG_MIN), 1)
    cuts = (torch.zeros if long.any() else torch.empty)(
        n, dtype=torch.bool, device=dev)
    if n and len(Ls):
        starts = _starts(Ls)
        # one host-to-device copy: starts, lens, beta bits of each path
        paths = [~long, long]
        packed = torch.as_tensor(np.concatenate(
            [np.concatenate([starts[p], Ls[p], beta[p].view(np.int64)])
             for p in paths]), device=dev)
        lib = _build.load("dlv_scan", _SIG)
        stream = _build.stream_ptr(dev)
        off = 0
        for is_long, p in enumerate(paths):
            k = int(p.sum())
            arg = [packed[off + i * k:off + (i + 1) * k] for i in range(3)]
            off += 3 * k
            if not k:
                continue
            ptrs = (vals.data_ptr(), arg[0].data_ptr(), arg[1].data_ptr(),
                    arg[2].view(torch.float64).data_ptr(), k,
                    cuts.data_ptr())
            if is_long:
                err = lib.dlv_scan_long_f64(
                    *ptrs, None, -1, st.data_ptr() if stats else None, stream)
            else:
                err = lib.dlv_scan_f64(*ptrs, stream)
            _build.check(err, "dlv_scan")
        launches += 1
    return (cuts, st) if stats else cuts


def verify_speculation(v, beta: float, spec):
    """The long path on ONE segment ``v`` with the caller's guess ``spec``
    (sorted distinct rows in [1, len(v)), at most ``SPEC_CAP``) in place of
    its first speculation: the compensated cuts, and the counters.  On a
    CUDA tensor it launches the long kernel; on a CPU tensor it runs
    :func:`long_scan_plain`."""
    global launches
    spec = np.asarray(spec, np.int64)
    L = len(v)
    if len(spec) > SPEC_CAP or (len(spec) and (
            spec.min() < 1 or spec.max() >= L or np.any(np.diff(spec) <= 0))):
        raise ValueError("verify_speculation: spec must be sorted distinct "
                         f"rows in [1, {L}), at most {SPEC_CAP}")
    if v.device.type != "cuda":
        got = {}
        cuts = long_scan_plain(v, beta, spec=spec, stats=got)
        return cuts, torch.as_tensor([got.get(k, 0) for k in STAT_NAMES])
    _check_vals(v)
    v = _aligned(v)
    dev = v.device
    meta = torch.as_tensor(np.array([0, L, np.float64(beta).view(np.int64)]),
                           device=dev)
    init = torch.as_tensor(spec, dtype=torch.int32, device=dev)
    cuts = torch.zeros(L, dtype=torch.bool, device=dev)
    st = torch.zeros(len(STAT_NAMES), dtype=torch.int64, device=dev)
    lib = _build.load("dlv_scan", _SIG)
    err = lib.dlv_scan_long_f64(
        v.data_ptr(), meta[0:1].data_ptr(), meta[1:2].data_ptr(),
        meta[2:3].view(torch.float64).data_ptr(), 1, cuts.data_ptr(),
        init.data_ptr(), len(spec), st.data_ptr(),
        _build.stream_ptr(dev))
    _build.check(err, "dlv_scan")
    launches += 1
    return cuts, st


# ------------------------------------------------------------ the seed scan


def _var_gt(q: float, m: float, b: float) -> bool:
    """Whether q - m*m, rounded once (the FMA of the seed scan's var),
    exceeds ``b``.  Twice rounded, q - m*m lies within 2 ulps of the
    once-rounded value, so outside 4 ulps of ``b`` it decides; nearer, the
    exact rational difference, rounded once, does."""
    p = m * m
    d = q - p
    if not math.isfinite(d) or abs(d - b) > 4.0 * math.ulp(max(abs(q), p)):
        return d > b
    return float(Fraction(q) - Fraction(m) * Fraction(m)) > b


def dlv_scan_seed_plain(vals, beta: float):
    """The seed's scan of ONE span in Python floats (IEEE float64): k1 =
    k + 1, s1 += x, s2 += x*x (each rounded), m = s1/k1, var = s2/k1 - m*m
    with the product and difference rounded once (the FMA that the
    reference's compiled scan computes), and on var > beta a cut that
    restarts the stats at (1, x, x*x).  Cut flags (bool) on ``vals``'s
    device."""
    b = float(beta)
    k = s1 = s2 = 0.0
    out = []
    for x in vals.tolist():
        k1 = k + 1.0
        s1n = s1 + x
        s2n = s2 + x * x
        cut = _var_gt(s2n / k1, s1n / k1, b)
        out.append(cut)
        if cut:
            k, s1, s2 = 1.0, x, x * x
        else:
            k, s1, s2 = k1, s1n, s2n
    return torch.tensor(out, dtype=torch.bool, device=vals.device)


# the certified seed scan's geometry (csrc/dlv_scan.cu): the prefix pass's
# tiles (threads x consecutive rows a thread); the walk's test (WALK_ROWS
# rows one by one, then WALK_BLOCKS blocks of WALK_L rows); after a window
# shorter than SEED_SHORT rows the reference's chain decides the next ones
SEED_SCAN = (512, 8)
WALK_ROWS = 256
WALK_BLOCKS = 256
WALK_L = 128
SEED_SHORT = 8
# its counters (``dlv_scan_seed(..., stats=True)``), in this order: windows
# (cuts after row 0, plus one), near-ties (serial chains run where the band
# could not decide), short runs (serial chains run after a short window),
# rows the serial chains stepped, the walk's tests, and cycles of the
# prefix pass (summed over its blocks), the tests and the serial chains
SEED_STAT_NAMES = ("windows", "near_ties", "short_runs", "serial_rows",
                   "tests", "prefix_cycles", "test_cycles", "serial_cycles")
# the kernels of one call, as the profiler names them
SEED_KERNELS = ("dlv_scan_seed_totals", "dlv_scan_seed_bases",
                "dlv_scan_seed_prefix", "dlv_scan_seed_walk")
_U4 = 2.0 ** -51             # 4u, u = 2^-53
_TAU = 2.0 ** -1000          # the band's absolute term (underflow)


def _dd_add(ah, al, bh, bl):
    """(ah + al) + (bh + bl) in double-double, as the kernel's ``dd_add``:
    the high parts' exact sum (two_sum), the low parts added to its error,
    renormalised exactly."""
    s = ah + bh
    bb = s - ah
    e = (ah - (s - bb)) + (bh - bb)
    e = e + (al + bl)
    h = s + e
    bb = h - s
    return h, (s - (h - bb)) + (e - bb)


def _shift(h, l, off: int):
    """(h, l) moved ``off`` places up along the last dim, zeros below."""
    z = torch.zeros_like(h[..., :off])
    return (torch.cat([z, h[..., :-off]], -1),
            torch.cat([z, l[..., :-off]], -1))


def _hillis_steele(h, l):
    """Inclusive scan along the last dim (a power of two wide) in the
    kernel's order: at each offset, the lower entry plus one's own."""
    off = 1
    while off < h.shape[-1]:
        nh, nl = _dd_add(h[..., :-off], l[..., :-off], h[..., off:],
                         l[..., off:])
        h = torch.cat([h[..., :off], nh], -1)
        l = torch.cat([l[..., :off], nl], -1)
        off *= 2
    return h, l


def _block_scan_plain(h, l, threads: int, rpt: int):
    """The kernel's ``tile_scan`` on rows of items (tiles, threads * rpt),
    double-doubles (h, l): each thread's rpt items in order from zero,
    a Hillis-Steele scan of the thread totals over the 32 lanes, one of
    the warp totals over the warps, then (warp prefix + lane prefix) +
    item prefix.  Returns the inclusive prefixes within each tile and the
    tiles' totals."""
    T, W = h.shape[0], threads // 32
    h = h.reshape(T, threads, rpt)
    l = l.reshape(T, threads, rpt)
    ch, cl = torch.empty_like(h), torch.empty_like(l)
    ah = torch.zeros(T, threads, dtype=h.dtype)
    al = torch.zeros_like(ah)
    for q in range(rpt):
        ah, al = _dd_add(ah, al, h[:, :, q], l[:, :, q])
        ch[:, :, q], cl[:, :, q] = ah, al
    vh, vl = _hillis_steele(ah.reshape(T, W, 32), al.reshape(T, W, 32))
    leh, lel = _shift(vh, vl, 1)
    wh, wl = _hillis_steele(vh[..., 31], vl[..., 31])
    weh, wel = _shift(wh, wl, 1)
    tbh, tbl = _dd_add(weh[..., None], wel[..., None], leh, lel)
    ph, pl = _dd_add(tbh.reshape(T, threads, 1), tbl.reshape(T, threads, 1),
                     ch, cl)
    return ph.reshape(T, -1), pl.reshape(T, -1), wh[:, -1], wl[:, -1]


def _seed_prefix_plain(vals, threads: int = SEED_SCAN[0],
                       rpt: int = SEED_SCAN[1]):
    """The prefix pass of the certified seed scan, bit for bit: the
    double-double prefix sums (P1h, P1l) of x and (P2h, P2l) of x*x, each
    of length n (``dlv_scan_seed_totals``, ``_bases``, ``_prefix``)."""
    tile = threads * rpt
    n = len(vals)
    nt = -(-n // tile)
    x = torch.zeros(nt * tile, dtype=torch.float64)
    x[:n] = vals.detach().cpu()
    zero = torch.zeros_like(x)
    out = []
    for h in (x, x * x):
        ph, pl, th, tl = _block_scan_plain(h.reshape(nt, tile),
                                           zero.reshape(nt, tile), threads,
                                           rpt)
        # the tile totals' inclusive scan, chunks of `tile` with a carry
        nc = -(-nt // tile)
        th2 = torch.zeros(nc * tile, dtype=torch.float64)
        tl2 = torch.zeros_like(th2)
        th2[:nt], tl2[:nt] = th, tl
        ih, il, _, _ = _block_scan_plain(th2.reshape(nc, tile),
                                         tl2.reshape(nc, tile), threads, rpt)
        ch = cl = torch.zeros((), dtype=torch.float64)
        for c in range(nc):
            ih[c], il[c] = _dd_add(ch, cl, ih[c], il[c])
            ch, cl = ih[c, -1], il[c, -1]
        bh, bl = _shift(ih.reshape(-1)[:nt], il.reshape(-1)[:nt], 1)
        ph, pl = _dd_add(bh[:, None], bl[:, None], ph, pl)
        out += [ph.reshape(-1)[:n], pl.reshape(-1)[:n]]
    return out


def _seed_bounds(p2_total: float, n: int):
    """The prefix error bounds of the band, from P2's total hi part (the
    kernel's arithmetic): (3 E1, 2 E2, 4 E1^2) with E1 = 16 (n + 2) u^2
    sqrt(n T2) and E2 = 16 (n + 2) u^2 T2, T2 = P2's total, 1 + 2^-40 up."""
    t2 = p2_total * (1.0 + 2.0 ** -40)
    g = (float(n) + 2.0) * 2.0 ** -102
    e2 = g * t2
    e1 = (g * math.sqrt(float(n) * t2)) * (1.0 + 2.0 ** -40)
    return 3.0 * e1, 2.0 * e2, (4.0 * e1) * e1


def _seed_band_terms(s1, s2, k, beta, bounds, ka=None):
    """The walk's test on window sums (s1, s2) of k rows, as the kernel's
    ``seed_classify`` rounds it: (d, bk, e, Wd, W) with d = k*s2 - s1*s1
    (an estimate of k^2 var_ref), bk = beta*k*k (beta*ka*k for a block
    whose first row has count ka), e = d - bk, Wd the band of |k^2 var_ref
    - d| and W = Wd + 4u|bk|, the whole band."""
    e1x3, e2x2, e1sq4 = bounds
    a = k * s2
    d = a - s1 * s1
    bk = (beta * (k if ka is None else ka)) * k
    e = d - bk
    w = ((k + 5.0) * _U4) * abs(a)
    w = w + k * (e2x2 + k * _TAU)
    w = w + abs(s1) * e1x3
    wd = w + e1sq4
    return d, bk, e, wd, wd + abs(bk) * _U4


def _seed_classify_plain(P, a, rows, j: int, beta: float, bounds,
                         starts=None):
    """The class of each row in ``rows`` (a tensor) in the window from j,
    as the kernel's ``seed_classify`` computes it (0 surely no cut, 1
    surely a cut, 2 uncertain); with ``starts``, of each block
    starts..rows (0: every row of it surely no cut, the bar beta*ka*kb)."""
    p1h, p1l, p2h, p2l = (q[rows] for q in P)
    s1 = (p1h - a[0]) + (p1l - a[1])
    s2 = (p2h - a[2]) + (p2l - a[3])
    kb = (rows - j + 1).to(torch.float64)
    ka = kb if starts is None else (starts - j + 1).to(torch.float64)
    _, _, e, _, w = _seed_band_terms(s1, s2, kb, beta, bounds, ka)
    cls = torch.full(rows.shape, 2, dtype=torch.int64)
    fin = torch.isfinite(e)
    cls[fin & (e < -w)] = 0
    cls[fin & (e > w)] = 1
    return cls


def _seed_serial_plain(x: list, j: int, h: int, b: float, hold: bool,
                       short: int, cuts):
    """The kernel's ``seed_serial`` in Python floats: the reference's
    chain from window start j, its sums alone before row h, then each
    row decided exactly, restarting at every cut; it stops at a cut that
    closes a window of ``short`` rows or more, or (once the first window
    has closed, or at once without ``hold``) when the current window
    reaches ``short`` rows without a cut, or at the end.  Sets the cuts;
    returns (first undecided row or len(x), window start there, rows
    stepped, cuts set)."""
    n = len(x)
    j0, ncut = j, 0
    k, s1, s2 = 1.0, x[j], x[j] * x[j]
    for r in range(j + 1, n):
        v = x[r]
        k += 1.0
        s1 += v
        s2 += v * v
        if r < h:
            continue
        if _var_gt(s2 / k, s1 / k, b):
            cuts[r] = True
            ncut += 1
            if r - j >= short:
                return r + 1, r, r - j0 + 1, ncut
            j, k, s1, s2, hold = r, 1.0, v, v * v, False
        elif not hold and r - j + 1 >= short:
            return r + 1, j, r - j0 + 1, ncut
    return n, j, n - j0, ncut


def seed_scan_certified_plain(vals, beta: float, *, rows: int = WALK_ROWS,
                              blocks: int = WALK_BLOCKS, block: int = WALK_L,
                              short: int = SEED_SHORT,
                              scan: tuple = SEED_SCAN, stats: dict = None):
    """The certified seed scan of ``csrc/dlv_scan.cu`` in plain torch, for
    the tests: the prefix pass (``scan`` = (threads, rows a thread)), then
    the walk -- each test takes ``rows`` rows one by one and ``blocks``
    blocks of ``block`` rows after them; the reference's chain at
    near-ties and after windows shorter than ``short`` -- with the same
    band.  ``stats`` (a dict) receives ``SEED_STAT_NAMES``' counts (the
    cycles 0).  Returns the cut flags (bool, on ``vals``' device), equal
    to :func:`dlv_scan_seed_plain`'s."""
    n = len(vals)
    b = float(beta)
    cuts = torch.zeros(n, dtype=torch.bool)
    count = dict.fromkeys(SEED_STAT_NAMES, 0)
    if n:
        P = _seed_prefix_plain(vals, *scan)
        x = vals.tolist()
        bounds = _seed_bounds(float(P[2][-1]), n)
        k1, s1, s2 = 1.0, 0.0 + x[0], 0.0 + x[0] * x[0]   # row 0's flag
        cuts[0] = _var_gt(s2 / k1, s1 / k1, b)
        count["windows"] = 1
        zero = torch.zeros((), dtype=torch.float64)
        a = (zero,) * 4
        j, lo = 0, 1
        offs = torch.cat([torch.arange(rows),
                          rows + torch.arange(blocks) * block])
        span = rows + blocks * block
        while lo < n:
            count["tests"] += 1
            if count["tests"] > 2 * n + 4:
                raise RuntimeError("seed_scan_certified_plain: the walk "
                                   "did not advance")
            starts = lo + offs
            single = torch.arange(len(offs)) < rows
            keep = starts < n
            starts, single = starts[keep], single[keep]
            ends = torch.where(single, starts,
                               torch.clamp(starts + block - 1, max=n - 1))
            cls = _seed_classify_plain(P, a, ends, j, b, bounds, starts)
            hit = torch.nonzero(cls).flatten()
            if not len(hit):
                lo += span
                continue
            m = int(starts[hit[0]])
            if not bool(single[hit[0]]):      # a block: its rows next
                lo = m
                continue
            jn, lon = m, m + 1
            if int(cls[hit[0]]) == 1 and m - j >= short:
                cuts[m] = True
                count["windows"] += 1
            else:
                if int(cls[hit[0]]) == 1:
                    cuts[m] = True
                    count["windows"] += 1
                    lon, jn, stepped, ncut = _seed_serial_plain(
                        x, m, m + 1, b, False, short, cuts)
                    count["short_runs"] += 1
                else:
                    lon, jn, stepped, ncut = _seed_serial_plain(
                        x, j, m, b, True, short, cuts)
                    count["near_ties"] += 1
                count["windows"] += ncut
                count["serial_rows"] += stepped
            if jn != j:
                a = tuple(q[jn - 1] for q in P)
            j, lo = jn, lon
    if stats is not None:
        stats.update(count)
    return cuts.to(vals.device)


def dlv_scan_seed(vals, beta: float, *, stats: bool = False,
                  serial: bool = False):
    """Cut flags (bool, like ``vals``) of the seed's scan over the one span
    ``vals`` (contiguous float64, already shifted by its mean) with bar
    ``beta``.  A CUDA tensor launches the certified design's four kernels
    (one count in ``seed_launches`` a call, whatever the length), or with
    ``serial`` the kernel it replaced (``dlv_scan_seed_serial``, one thread
    walks the span; counted in ``seed_serial_launches``); a CPU tensor runs
    :func:`dlv_scan_seed_plain`.  With ``stats`` the result is (cuts, the
    counters: an int64 tensor in ``SEED_STAT_NAMES`` order, zeros on the
    CPU and for ``serial``)."""
    global seed_launches, seed_serial_launches
    if vals.device.type != "cuda":
        cuts = dlv_scan_seed_plain(vals, beta)
        return (cuts, torch.zeros(len(SEED_STAT_NAMES), dtype=torch.int64)) \
            if stats else cuts
    _check_vals(vals)
    n = len(vals)
    if n >= 1 << 31:
        raise ValueError("dlv_scan_seed: a span of 2^31 rows or more")
    dev = vals.device
    st = torch.zeros(len(SEED_STAT_NAMES), dtype=torch.int64, device=dev) \
        if stats else None
    lib = _build.load("dlv_scan", _SIG)
    stream = _build.stream_ptr(dev)
    if serial:
        cuts = torch.empty(n, dtype=torch.bool, device=dev)
        if n:
            _build.check(lib.dlv_scan_seed_serial_f64(
                vals.data_ptr(), n, float(beta), cuts.data_ptr(), stream),
                "dlv_scan_seed")
            seed_serial_launches += 1
    else:
        cuts = torch.zeros(n, dtype=torch.bool, device=dev)
        if n:
            tile = SEED_SCAN[0] * SEED_SCAN[1]
            nt = -(-n // tile)
            # P (32 bytes a row), then the tile totals and their scan
            scratch = torch.empty(4 * (n + 2 * nt), dtype=torch.float64,
                                  device=dev)
            _build.check(lib.dlv_scan_seed_f64(
                vals.data_ptr(), n, float(beta), cuts.data_ptr(),
                scratch.data_ptr(), st.data_ptr() if stats else None,
                stream), "dlv_scan_seed")
            seed_launches += 1
    return (cuts, st) if stats else cuts
