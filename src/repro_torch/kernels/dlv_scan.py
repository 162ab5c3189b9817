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
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

launches = 0

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
        + (_build.I64, _build.P, _build.P)}


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
