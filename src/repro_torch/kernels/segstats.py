"""Segment statistics: per-group count, sum and sum of squares.

Replaces ``repro/kernels/segstats.py::_segstats_kernel`` (Pallas, TPU;
float32 one-hot matmuls) with the contract of the reference's exact
float64 host twin ``segment_stats_np``: ``vals`` (n, k) float64, ``ids``
(n,) sorted ascending, results (G,), (G, k), (G, k) in float64, zero for
a group with no rows.

On a CUDA tensor :func:`segment_stats` launches ``csrc/segstats.cu``, a
tiled segmented reduction in a fixed order (see the source note): one
CTA per tile of rows writes every group that starts and ends in its tile
and leaves one carry record; a second launch merges the records with a
fixed tree.  Two runs agree bit for bit.  On a CPU tensor it runs
:func:`segment_stats_plain`.  :func:`segment_stats_tiled_plain` is the
kernel's order of additions in torch (the same tiles, thread walks, scan
trees and carry merge), bit-equal to the kernel on the card; the main
path never calls it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_K = 8
LANES = 32               # csrc/segstats.cu: a warp
WARPS = 8                # csrc/segstats.cu WARPS: pass 1's CTA
MERGE_WARPS = 16         # csrc/segstats.cu MERGE_WARPS: the carry merge
TILE_ROWS = 8192         # rows a tile aims at (chip_smoke's "segstats tile")
launches = 0

_SIG = {"segstats_f64": (_build.P, _build.P) + (_build.I64,) * 4
        + (_build.P,) * 5}


def rows_per_thread(k: int) -> int:
    """Consecutive rows one lane walks per step (csrc/segstats.cu
    ``rows_per_thread``): about 16 values, at most 8 rows."""
    return min(8, max(1, 16 // k))


def step_rows(k: int) -> int:
    """Rows one CTA takes per step: a step of each of its warps."""
    return LANES * WARPS * rows_per_thread(k)


def tile_rows(k: int) -> int:
    """The kernel's tile: the whole steps nearest below ``TILE_ROWS``."""
    return max(1, TILE_ROWS // step_rows(k)) * step_rows(k)


def segment_stats_plain(vals, ids, num_groups: int):
    """Plain torch version: ``index_add_`` of 1, v and v*v per group."""
    G, k = int(num_groups), vals.shape[1]
    dev, dt = vals.device, vals.dtype
    cnt = torch.zeros(G, dtype=dt, device=dev)
    sums = torch.zeros((G, k), dtype=dt, device=dev)
    sqs = torch.zeros((G, k), dtype=dt, device=dev)
    ids = ids.to(torch.int64)
    cnt.index_add_(0, ids, torch.ones(len(ids), dtype=dt, device=dev))
    sums.index_add_(0, ids, vals)
    sqs.index_add_(0, ids, vals * vals)
    return cnt, sums, sqs


# ------------------------------------------- the kernel's order, in torch


def _combine(fa, va, fb, vb):
    """a then b under a segmented sum: b where b holds a head, else
    a + b (the kernel's ``combine``)."""
    return fa | fb, torch.where(fb[..., None], vb, va + vb)


def _shift(f, v, d):
    """Each lane's element ``d`` lanes down the last axis of ``f`` (the
    one before last of ``v``); the identity where there is none."""
    fs, vs = torch.zeros_like(f), torch.zeros_like(v)
    fs[..., d:] = f[..., :-d]
    vs[..., d:, :] = v[..., :-d, :]
    return fs, vs


def _hs(f, v):
    """Inclusive segmented scan over the last axis of ``f`` by doubling
    strides, every lane from the old values (the kernel's ``warp_hs``)."""
    width, d = f.shape[-1], 1
    while d < width:
        fs, vs = _shift(f, v, d)
        keep = f | (torch.arange(width, device=f.device) < d)
        f, v = f | fs, torch.where(keep[..., None], v, vs + v)
        d *= 2
    return f, v


def _chain(lf, lv, tf, tv, cf, cv, live=None):
    """Carry chained over the blocks of axis 1: each element's exclusive
    value is carry then its in-block exclusive (``lf``, ``lv``: (B, C,
    ...)); a block moves the carry on by its total (``tf``, ``tv``: (B,
    C)), unless ``live`` (B, C) marks it False (a step past the last row,
    which the kernel never runs).  Returns the exclusive values and the
    carries coming out."""
    ef, ev = torch.empty_like(lf), torch.empty_like(lv)
    pad = (None,) * (lf.dim() - 2)
    for c in range(lf.shape[1]):
        ef[:, c], ev[:, c] = _combine(cf[(...,) + pad],
                                      cv[(slice(None),) + pad], lf[:, c],
                                      lv[:, c])
        nf, nv = _combine(cf, cv, tf[:, c], tv[:, c])
        if live is not None:
            nf = torch.where(live[:, c], nf, cf)
            nv = torch.where(live[:, c, None], nv, cv)
        cf, cv = nf, nv
    return ef, ev, cf, cv


def _block_scan(f, v):
    """The kernel's ``block_scan`` over chained blocks of threads: ``f``
    (B, C, W, L) and ``v`` (B, C, W, L, D) are B chains of C blocks of W
    warps of L lanes.  A thread's exclusive value is carry, then (the
    warps before its own, then the lanes before it in its warp).  Returns
    the exclusive (f, v) of every thread."""
    fi, vi = _hs(f, v)
    lf, lv = _shift(fi, vi, 1)
    tf, tv = _hs(fi[..., -1], vi[..., -1, :])          # (B, C, W)
    xf, xv = _shift(tf, tv, 1)
    xlf, xlv = _combine(xf[..., None], xv[..., None, :], lf, lv)
    B, D = f.shape[0], v.shape[-1]
    zf = torch.zeros(B, dtype=torch.bool, device=f.device)
    zv = torch.zeros((B, D), dtype=v.dtype, device=f.device)
    return _chain(xlf, xlv, tf[..., -1], tv[..., -1, :], zf, zv)[:2]


def segment_stats_tiled_plain(vals, ids, num_groups: int, *, tile=None,
                              rows=None, lanes: int = LANES,
                              warps: int = WARPS,
                              merge_warps: int = MERGE_WARPS):
    """The kernel's order of additions in torch: its output bit for bit.

    A tile of ``tile`` rows is ``warps`` spans of consecutive rows, one
    a warp; a span is steps of ``lanes * rows`` rows.  In a step each
    lane walks ``rows`` consecutive rows in order, starting a new sum at
    each head (a row whose id differs from the row before); the lanes'
    trailing sums are scanned by doubling strides (:func:`_hs`) and
    chained over the span's steps.  A run closed in the span with its
    head there is written at once; the span's first run, begun before
    it, is its carry piece.  At the tile's end the spans' trailing sums
    are scanned: a span's carry piece after that scan is a whole run if
    its head lies in the tile, else the tile's carry piece, added in the
    merge to the scan of the tiles' trailing sums (:func:`_block_scan`,
    ``lanes * merge_warps`` tiles a block).  The defaults are the
    kernel's geometry; small ones cross many tiles with few rows."""
    n, k = vals.shape
    G, dev = int(num_groups), vals.device
    R = rows_per_thread(k) if rows is None else int(rows)
    step = R * lanes * warps
    if tile is None:
        tile = max(1, TILE_ROWS // step) * step
    if tile <= 0 or tile % step:
        raise ValueError(f"tile {tile} is not a whole number of "
                         f"{step}-row steps")
    D = 1 + 2 * k
    out = torch.zeros((G, D), dtype=torch.float64, device=dev)
    if n:
        ids = ids.to(torch.int64)
        S, B = tile // step, -(-n // tile)
        N = B * tile
        X = torch.zeros((N, D), dtype=torch.float64, device=dev)
        X[:n, 0] = 1.0
        X[:n, 1:1 + k] = vals
        X[:n, 1 + k:] = vals * vals
        present = torch.arange(N, device=dev) < n
        head = torch.zeros(N, dtype=torch.bool, device=dev)
        head[0] = True
        head[1:n] = ids[1:] != ids[:-1]
        closes = torch.zeros(N, dtype=torch.bool, device=dev)
        closes[:n - 1] = ids[1:] != ids[:-1]
        closes[n - 1] = True
        gid = torch.zeros(N, dtype=torch.int64, device=dev)
        gid[:n] = ids
        shape = (B, warps, S, lanes, R)            # tile, span, step, lane
        X, present, head, closes, gid = (
            t.reshape(*shape, *t.shape[1:])
            for t in (X, present, head, closes, gid))

        def write(mask, g, v):
            ok = mask & (g >= 0) & (g < G)
            out[g[ok]] = v[ok]

        # each lane's walk over its rows, all lanes at once
        acc = torch.zeros(shape[:-1] + (D,), dtype=torch.float64,
                          device=dev)
        h = torch.zeros(shape[:-1], dtype=torch.bool, device=dev)
        fp, fpc = torch.zeros_like(acc), torch.zeros_like(h)
        fpg = torch.zeros(shape[:-1], dtype=torch.int64, device=dev)
        for j in range(R):
            x, pr = X[..., j, :], present[..., j, None]
            acc = torch.where(head[..., j, None], 0.0, acc)
            acc = torch.where(pr, acc + x, acc)
            h = h | head[..., j]
            cl = closes[..., j]
            write(cl & h, gid[..., j], acc)        # head and end here
            first = cl & ~h                        # closes a run begun
            fp = torch.where(first[..., None], acc, fp)   # before it
            fpc, fpg = fpc | first, torch.where(first, gid[..., j], fpg)

        # the span: lanes scanned, steps chained
        BW = B * warps
        fi, vi = _hs(h, acc)
        lf, lv = _shift(fi, vi, 1)
        zf = torch.zeros(BW, dtype=torch.bool, device=dev)
        zv = torch.zeros((BW, D), dtype=torch.float64, device=dev)
        ef, ev, sf, sv = _chain(
            lf.reshape(BW, S, lanes), lv.reshape(BW, S, lanes, D),
            fi[..., -1].reshape(BW, S), vi[..., -1, :].reshape(BW, S, D),
            zf, zv, present.reshape(BW, S, -1).any(2))
        tot = ev.reshape(acc.shape) + fp
        write(fpc & ef.reshape(h.shape), fpg, tot)  # begun in this span
        carry = fpc & ~ef.reshape(h.shape)          # begun before it:
        pf = carry.reshape(BW, -1).any(1)           # one piece a span
        pv = torch.zeros((BW, D), dtype=torch.float64, device=dev)
        pv[carry.reshape(BW, -1).nonzero()[:, 0]] = tot[carry]

        # the tile: the spans' trailing sums scanned
        tf, tv = _hs(sf.reshape(B, warps), sv.reshape(B, warps, D))
        xf, xv = _shift(tf, tv, 1)
        pf, pv = pf.reshape(B, warps), xv + pv.reshape(B, warps, D)
        write(pf & xf, gid[:, :, 0, 0, 0], pv)      # begun in this tile
        tile_p = pf & ~xf                           # begun before it:
        qf = tile_p.any(1)                          # one piece a tile
        qv = torch.zeros((B, D), dtype=torch.float64, device=dev)
        qv[tile_p.nonzero()[:, 0]] = pv[tile_p]

        # the merge: the tiles' trailing sums scanned in blocks of
        # merge_warps * lanes tiles, chained
        M = lanes * merge_warps
        Bc = -(-B // M)
        mf = torch.zeros(Bc * M, dtype=torch.bool, device=dev)
        mv = torch.zeros((Bc * M, D), dtype=torch.float64, device=dev)
        mf[:B], mv[:B] = tf[:, -1], tv[:, -1]
        _, mv = _block_scan(mf.reshape(1, Bc, merge_warps, lanes),
                            mv.reshape(1, Bc, merge_warps, lanes, D))
        mv = mv.reshape(-1, D)[:B]
        write(qf, gid[:, 0, 0, 0, 0], mv + qv)
    return out[:, 0], out[:, 1:1 + k], out[:, 1 + k:]


# -------------------------------------------------------------- kernel


def segment_stats(vals, ids, num_groups: int, *, tile=None):
    """(counts (G,), sums (G, k), sumsqs (G, k)) for sorted ``ids``.

    ``tile``: rows a CTA on the card, a whole number of ``step_rows(k)``;
    ``tile_rows(k)`` by default.  Two launches a call (tiles, then the
    carry merge); none for n = 0."""
    global launches
    if vals.device.type != "cuda":
        return segment_stats_plain(vals, ids, num_groups)
    if vals.dtype != torch.float64 or vals.dim() != 2 \
            or not vals.is_contiguous():
        raise ValueError("segment_stats: vals must be a contiguous (n, k) "
                         "float64 tensor")
    n, k = vals.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"segment_stats kernel takes 1 <= k <= {MAX_K}, "
                         f"got {k}")
    if ids.device != vals.device or ids.dtype != torch.int64 \
            or ids.shape != (n,) or not ids.is_contiguous():
        raise ValueError("segment_stats: ids must be a contiguous (n,) int64 "
                         f"tensor on {vals.device}")
    T = tile_rows(k) if tile is None else int(tile)
    if T <= 0 or T % step_rows(k):
        raise ValueError(f"segment_stats: tile {T} is not a whole number "
                         f"of {step_rows(k)}-row steps")
    G = int(num_groups)
    dev = vals.device
    if n == 0:
        return (torch.zeros(G, dtype=torch.float64, device=dev),
                torch.zeros((G, k), dtype=torch.float64, device=dev),
                torch.zeros((G, k), dtype=torch.float64, device=dev))
    # every group is written by the kernel (empty ones with 0)
    cnt = torch.empty(G, dtype=torch.float64, device=dev)
    sums = torch.empty((G, k), dtype=torch.float64, device=dev)
    sqs = torch.empty((G, k), dtype=torch.float64, device=dev)
    ntiles = -(-n // T)
    rec = torch.empty(ntiles * 2 * (2 + 2 * k), dtype=torch.float64,
                      device=dev)
    err = _build.load("segstats", _SIG).segstats_f64(
        vals.data_ptr(), ids.data_ptr(), n, k, G, T, cnt.data_ptr(),
        sums.data_ptr(), sqs.data_ptr(), rec.data_ptr(),
        _build.stream_ptr(dev))
    _build.check(err, "segment_stats")
    launches += 2
    return cnt, sums, sqs
