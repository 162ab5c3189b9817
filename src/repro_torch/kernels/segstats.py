"""Segment statistics: per-group count, sum and sum of squares.

Replaces ``repro/kernels/segstats.py::_segstats_kernel`` (Pallas, TPU;
float32 one-hot matmuls) with the contract of the reference's exact
float64 host twin ``segment_stats_np``: ``vals`` (n, k) float64, ``ids``
(n,) sorted ascending, results (G,), (G, k), (G, k) in float64.

On a CUDA tensor :func:`segment_stats` launches ``csrc/segstats.cu``
(row-tiled segmented reduction, deterministic, bound by the bytes of
``vals`` it reads once — see the source note); on a CPU tensor it runs
:func:`segment_stats_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_K = 8
launches = 0

_SIG = {"segstats_f64": (_build.P, _build.P, _build.I64, _build.I64)
        + (_build.P,) * 6,
        "segstats_nchunks": (_build.I64,)}


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


def segment_stats(vals, ids, num_groups: int):
    """(counts (G,), sums (G, k), sumsqs (G, k)) for sorted ``ids``."""
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
    G = int(num_groups)
    dev = vals.device
    cnt = torch.zeros(G, dtype=torch.float64, device=dev)
    sums = torch.zeros((G, k), dtype=torch.float64, device=dev)
    sqs = torch.zeros((G, k), dtype=torch.float64, device=dev)
    lib = _build.load("segstats", _SIG)
    lib.segstats_nchunks.restype = _build.I64
    nch = lib.segstats_nchunks(n)
    scratch_i = torch.empty(max(2 * nch, 1), dtype=torch.int64, device=dev)
    scratch_f = torch.empty(max(2 * nch * (1 + 2 * k), 1),
                            dtype=torch.float64, device=dev)
    err = lib.segstats_f64(vals.data_ptr(), ids.data_ptr(), n, k,
                           cnt.data_ptr(), sums.data_ptr(), sqs.data_ptr(),
                           scratch_i.data_ptr(), scratch_f.data_ptr(),
                           _build.stream_ptr(dev))
    _build.check(err, "segment_stats")
    launches += 1
    return cnt, sums, sqs
