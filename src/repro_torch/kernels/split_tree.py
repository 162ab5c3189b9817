"""Split-tree descent: GetGroup for a whole batch of tuples.

Replaces ``repro/core/partitioner.py::_descend_batch_jax`` (a jitted
``lax.while_loop`` over tree levels, not Pallas).  The tree is the flat
array split tree of ``core.partitioner.SplitTree``: node ``i`` splits on
``attr[i]`` at ``bounds[bound_off[i]:bound_off[i+1]]``, its children sit
at ``children[bound_off[i] + i:]``, and a child ``< 0`` is the leaf
``~gid``.

On a CUDA tensor :func:`descend_batch` launches ``csrc/split_tree.cu``
(one thread a row, each row bisecting its own path; see the source note);
on a CPU tensor it runs :func:`descend_batch_plain`, the reference's
lockstep masked bisection (``SplitTree.descend_batch``) in torch.  Both
compare ``bounds[mid] <= v`` and nothing else, so they give the same
leaves bit for bit, NaN rows and ties included.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0

_SIG = {"split_tree_f64": (_build.P, _build.I64, _build.I64) + (_build.P,) * 4
        + (_build.I64, _build.I64, _build.P, _build.P)}


def descend_batch_plain(T, attr, bound_off, bounds, children, root: int):
    """Plain torch version (any device): every row descends in lockstep,
    one masked bisection a level over each row's own bounds slice."""
    m = T.shape[0]
    cur = torch.full((m,), int(root), dtype=torch.int64, device=T.device)
    if attr.numel() == 0:
        return ~cur
    act = torch.nonzero(cur >= 0).flatten()
    last = bounds.numel() - 1
    while act.numel():
        nodes = cur[act]
        vals = T[act, attr[nodes].long()]
        lo = bound_off[nodes].clone()
        hi = bound_off[nodes + 1].clone()
        live = lo < hi
        while bool(live.any()):
            mid = (lo + hi) >> 1
            take = live & (bounds[mid.clamp(max=last)] <= vals)
            lo = torch.where(take, mid + 1, lo)
            hi = torch.where(live & ~take, mid, hi)
            live = lo < hi
        cur[act] = children[nodes + lo]      # child base = bound_off + node
        act = act[cur[act] >= 0]
    return ~cur


def descend_batch(T, attr, bound_off, bounds, children, root: int):
    """(m,) int64 leaf ids of the rows of ``T`` (m, k) float64.

    The tree's arrays lie on ``T``'s device: ``attr`` int32 (N,),
    ``bound_off`` int64 (N+1,), ``bounds`` float64 (B,), ``children`` int64
    (B+N,).  One launch a call on the card (also for m = 0)."""
    global launches
    if T.device.type != "cuda":
        return descend_batch_plain(T, attr, bound_off, bounds, children,
                                   root)
    if T.dtype != torch.float64 or T.dim() != 2 or not T.is_contiguous():
        raise ValueError("split_tree: T must be a contiguous (m, k) float64 "
                         "tensor")
    N = attr.numel()
    for name, t, dt, n in (("attr", attr, torch.int32, N),
                           ("bound_off", bound_off, torch.int64, N + 1),
                           ("bounds", bounds, torch.float64, None),
                           ("children", children, torch.int64, None)):
        if t.device != T.device or t.dtype != dt or t.dim() != 1 \
                or not t.is_contiguous() or (n is not None and t.numel() != n):
            raise ValueError(f"split_tree: {name} must be a contiguous 1-d "
                             f"{dt} tensor on {T.device}")
    if children.numel() != bounds.numel() + N:
        raise ValueError("split_tree: children must hold one more entry a "
                         "node than bounds")
    m, k = T.shape
    out = torch.empty(m, dtype=torch.int64, device=T.device)
    err = _build.load("split_tree", _SIG).split_tree_f64(
        T.data_ptr(), m, k, attr.data_ptr(), bound_off.data_ptr(),
        bounds.data_ptr(), children.data_ptr(), int(root), N,
        out.data_ptr(), _build.stream_ptr(T.device))
    _build.check(err, "split_tree")
    launches += 1
    return out
