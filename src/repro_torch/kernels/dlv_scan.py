"""DLV Algorithm-5 cut scan over many concatenated sorted segments.

Replaces the jitted JAX scan ``repro/core/dlv.py::_dlv_scan_cols`` (the
TPU branch of ``_seg_cuts``).  ``vals`` holds the segments back to back,
each sorted ascending and centred on its own mean, with lengths ``Ls`` and
split bars ``beta``; the result flags every row before which a delimiter
is placed (before snapping to equal-value run starts, which the caller
does).

On a CUDA tensor :func:`dlv_scan` launches ``csrc/dlv_scan.cu`` (one
thread per segment, Kahan-compensated float64 row steps, built without
FMA contraction; a serial dependency chain bounds it — see the source
note).  On a CPU tensor it runs :func:`dlv_scan_plain`, the reference's
float64 host path in torch: segments grouped by length, wide groups
through the compensated column row-step scan (the kernel's arithmetic,
bit for bit), narrow groups and long segments through the exact
cut-to-cut jump scan (same cut rule, prefix-sum rounding).

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

_SIG = {"dlv_scan_f64": (_build.P,) * 4 + (_build.I64, _build.P, _build.P)}


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


def dlv_scan(vals, Ls, beta, *, pitch: int = 256):
    """Cut flags (bool, like ``vals``) for the segments of ``vals``.

    ``Ls`` (segment lengths, summing to ``len(vals)``) and ``beta``
    (per-segment bars) are host arrays; ``pitch`` (the expected distance
    between cuts) only steers the plain version's choice of scan.
    """
    global launches
    if vals.device.type != "cuda":
        return dlv_scan_plain(vals, Ls, beta, pitch=pitch)
    if vals.dtype != torch.float64 or vals.dim() != 1 \
            or not vals.is_contiguous():
        raise ValueError("dlv_scan: vals must be a contiguous 1-d float64 "
                         "tensor")
    Ls = np.asarray(Ls, np.int64)
    beta = np.asarray(beta, np.float64)
    n = len(vals)
    if int(Ls.sum()) != n or len(beta) != len(Ls):
        raise ValueError("dlv_scan: segment lengths must sum to len(vals) "
                         "and match beta")
    dev = vals.device
    cuts = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0 or len(Ls) == 0:
        return cuts
    starts_t = torch.as_tensor(_starts(Ls), dtype=torch.int64, device=dev)
    lens_t = torch.as_tensor(Ls, dtype=torch.int64, device=dev)
    beta_t = torch.as_tensor(beta, dtype=torch.float64, device=dev)
    lib = _build.load("dlv_scan", _SIG)
    err = lib.dlv_scan_f64(vals.data_ptr(), starts_t.data_ptr(),
                           lens_t.data_ptr(), beta_t.data_ptr(), len(Ls),
                           cuts.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "dlv_scan")
    launches += 1
    return cuts
