"""Split-tree descent: GetGroup for a whole batch of tuples.

Replaces ``repro/core/partitioner.py::_descend_batch_jax`` (a jitted
``lax.while_loop`` over tree levels, not Pallas).  The tree is the flat
array split tree of ``core.partitioner.SplitTree``: node ``i`` splits on
``attr[i]`` at ``bounds[bound_off[i]:bound_off[i+1]]``, its children sit
at ``children[bound_off[i] + i:]``, and a child ``< 0`` is the leaf
``~gid``.

The card's kernel (``csrc/split_tree.cu``) walks a derived layout that
:func:`pack_tree` builds once per tree and device (``SplitTree.
device_arrays``), with the nodes renumbered breadth first and ids in
int32:

- a 16-byte record a node: attribute, bound count, whether its children
  are a run of leaves ``~g0, ~(g0+1), ...`` (the kernel then computes the
  child), the child below its first bound, its second child (a one-bound
  node) or its first line, and its first fence;
- the fences: bounds ``0, 8, 16, ...`` of each node, bisected to pick the
  line a row reads;
- 64-byte lines: bounds ``8L+1 .. 8L+7`` of a node in the order the
  kernel reads them (:data:`LINE_ORDER`: two 16-byte loads decide among
  the 8 counts), and beside them ``kids``, the children the line's counts
  select.

The kernel stages the records, then the fences, then the lines (each a
prefix in breadth-first order) in shared memory, as much as
:data:`STAGE_BYTES` holds (:func:`plan`), and keeps each row's ``k``
values in registers.

:func:`descend_batch` launches the kernel on a CUDA tensor and runs
:func:`descend_batch_plain`, the reference's lockstep masked bisection
(``SplitTree.descend_batch``) in torch, on a CPU tensor.
:func:`descend_batch_packed_plain` walks the packed layout in the
kernel's order in torch.  :func:`descend_batch_bisect` launches the
kernel the packed walk replaced (``csrc/split_tree_bisect.cu``: one
thread a row bisecting the tree's own arrays), which no path runs: it is
the baseline that ``chip_smoke.py`` and ``scripts/split_tree_layouts.py``
time beside the packed walk.  All four compare ``bound <= v`` and nothing
else, so a NaN value goes left, a tie goes right, and on a tree whose
nodes' bounds are non-decreasing and free of NaN (:func:`pack_tree`
raises on any other) they give the same leaves bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build

launches = 0

LINE = 8                  # csrc/split_tree.cu: bounds a line
REC_BYTES, LINE_BYTES, FENCE_BYTES = 16, 64, 8
NB_MAX, ATTR_MAX = (1 << 23) - 1, 255   # a record's meta bits
# shared memory a block stages (two blocks of 1,024 threads an SM): the
# records and the top fences of a 10M-row DLV tree
# (scripts/split_tree_layouts.py times it against none); the kernel takes
# at most STAGE_MAX, what a block has without opting in
STAGE_BYTES, STAGE_MAX = 40 * 1024, 48 * 1024

_SIG = {"split_tree_f64": (_build.P, _build.I64, _build.I64, _build.I64)
        + (_build.P,) * 4 + (_build.I64,) * 5 + (_build.P, _build.P)}
_BISECT_SIG = {"split_tree_bisect_f64": (_build.P, _build.I64, _build.I64)
               + (_build.P,) * 4 + (_build.I64, _build.I64, _build.P,
                                    _build.P)}


@dataclasses.dataclass(eq=False)
class PackedTree:
    """A split tree on one device: its own arrays (the plain version's
    input) and the packed layout (the kernel's), nodes renumbered breadth
    first.  ``recs`` (N, 4) int32: ``meta`` (``attr | nb << 8 | run <<
    31``, ``run`` when the children are the leaves ``~g0, ~(g0+1), ...``),
    ``child0``, ``child1`` (``nb == 1``) or the first line (``nb >= 2``),
    and the first fence; ``fences`` (F,) float64: bounds ``0, 8, 16, ...``
    of each node with bounds; ``lines`` (L, 8) float64: bounds ``8i+1 ..
    8i+7`` of each node with two bounds or more in ``LINE_ORDER`` (NaN
    past its last), and ``kids`` (L, 8) int32 the children ``8i+1 ..
    8i+8`` they select."""
    arrays: tuple         # (attr, bound_off, bounds, children)
    root: int             # of the arrays; the packed root is node 0
    recs: torch.Tensor
    fences: torch.Tensor
    lines: torch.Tensor
    kids: torch.Tensor
    depth: int            # nodes on the longest path from the root

    @property
    def num_nodes(self) -> int:
        return self.recs.shape[0]

    @property
    def packed_root(self) -> int:
        return 0 if self.root >= 0 else self.root

    @functools.cached_property
    def staged(self) -> "Plan":
        """:func:`plan` at ``STAGE_BYTES``: what every launch stages."""
        return plan(self)


def _node_of(bound_off, idx):
    return np.searchsorted(bound_off, idx, side="right") - 1


def check_shapes(attr, bound_off, bounds, children, root: int) -> None:
    """Raise ``ValueError`` unless the four arrays are one split tree's:
    ``bound_off`` N + 1 non-decreasing offsets from 0 to the bound count,
    ``children`` bounds + N entries whose node ids (``>= 0``) lie below N,
    and ``root`` a node id or a leaf."""
    n = len(attr)
    if attr.ndim != 1 or bound_off.shape != (n + 1,) or bounds.ndim != 1:
        raise ValueError(f"split tree: {n} nodes need {n + 1} bound offsets "
                         f"and 1-D attributes and bounds, got offsets of "
                         f"shape {bound_off.shape}")
    if bound_off[0] != 0 or bound_off[-1] != len(bounds) or \
            (np.diff(bound_off) < 0).any():
        raise ValueError("split tree: bound offsets must rise from 0 to the "
                         f"{len(bounds)} bounds")
    if children.shape != (len(bounds) + n,):
        raise ValueError(f"split tree: {len(bounds)} bounds and {n} nodes "
                         f"need {len(bounds) + n} children, got "
                         f"{children.shape[0]}")
    if (children >= n).any() or root >= n:
        raise ValueError(f"split tree: a child or the root names a node "
                         f"beyond the {n} nodes")


def check_sorted(bound_off, bounds) -> None:
    """Raise ``ValueError`` naming the first node whose bounds hold a NaN
    or descend: the packed layout's fence search equals the reference's
    bisection only on non-decreasing bounds free of NaN."""
    nan = np.flatnonzero(np.isnan(bounds))
    if len(nan):
        raise ValueError(f"split tree node {int(_node_of(bound_off, nan[0]))}"
                         " has a NaN bound; the packed descent needs "
                         "non-decreasing bounds free of NaN")
    down = np.flatnonzero(bounds[1:] < bounds[:-1]) + 1
    down = down[~np.isin(down, bound_off)]       # within one node only
    if len(down):
        raise ValueError(f"split tree node {int(_node_of(bound_off, down[0]))}"
                         " has descending bounds; the packed descent needs "
                         "non-decreasing bounds free of NaN")


def _bfs_order(bound_off, children, root: int, n: int):
    """(order, depth): node ids breadth first from ``root`` (each node at
    its first visit; nodes the root does not reach follow in id order),
    and the levels of the longest path."""
    seen = np.zeros(n, bool)
    order, depth = [], 0
    front = np.array([root] if root >= 0 else [], np.int64)
    while len(front):
        seen[front] = True
        order.append(front)
        depth += 1
        cnt = bound_off[front + 1] - bound_off[front] + 1
        base = bound_off[front] + front
        idx = np.repeat(base - np.concatenate([[0], np.cumsum(cnt)[:-1]]),
                        cnt) + np.arange(int(cnt.sum()))
        kids = children[idx]
        kids = kids[kids >= 0]
        kids = kids[~seen[kids]]
        _, first = np.unique(kids, return_index=True)
        front = kids[np.sort(first)]
    order.append(np.flatnonzero(~seen))
    return np.concatenate(order).astype(np.int64), depth


# the slots of a line in the order the kernel reads them: its bounds 3 and
# 6 split the line's counts 1..8 in three, then the pair of that third
# decides (bound 0 is the fence that chose the line; -1: NaN)
LINE_ORDER = np.array([3, 6, 1, 2, 4, 5, 7, -1])


def pack_tree(attr, bound_off, bounds, children, root: int,
              device) -> PackedTree:
    """The packed layout of a split tree's numpy arrays, with the arrays
    themselves, as tensors on ``device``.  Raises ``ValueError`` on arrays
    that are not one tree's (:func:`check_shapes`) and on a node whose
    bounds hold a NaN or descend."""
    attr = np.ascontiguousarray(attr, np.int32)
    bound_off = np.ascontiguousarray(bound_off, np.int64)
    bounds = np.ascontiguousarray(bounds, np.float64)
    children = np.ascontiguousarray(children, np.int64)
    check_shapes(attr, bound_off, bounds, children, int(root))
    check_sorted(bound_off, bounds)
    n = len(attr)
    order, depth = _bfs_order(bound_off, children, int(root), n)
    new_id = np.empty(n, np.int64)
    new_id[order] = np.arange(n)

    def remap(c):
        return np.where(c >= 0, new_id[np.maximum(c, 0)], c)

    off = bound_off[order]
    nb = bound_off[order + 1] - off
    base = off + order                         # first child of each node
    nf = (nb + LINE - 1) // LINE               # fences (= lines if nb >= 2)
    nl = np.where(nb >= 2, nf, 0)
    f0, line0 = np.cumsum(nf) - nf, np.cumsum(nl) - nl
    # a node whose children are the leaves ~g0, ~(g0+1), ...: the kernel
    # computes the child of count p as child0 - p and reads no child
    kid = np.repeat(np.arange(n), nb + 1)
    p = np.arange(len(kid)) - np.repeat(np.cumsum(nb + 1) - nb - 1, nb + 1)
    c0 = children[base]
    off_run = children[base[kid] + p] != c0[kid] - p
    run = (c0 < 0) & (np.bincount(kid, off_run, n) == 0)
    if n and (nb.max() > NB_MAX or attr.max() > ATTR_MAX or
              -children.min() > 2**31 or n + len(bounds) >= 2**31):
        raise ValueError("split tree too large for the packed layout: "
                         f"a node with more than {NB_MAX} bounds, an "
                         f"attribute above {ATTR_MAX}, or ids beyond int32")
    one = nb == 1
    meta = attr[order].astype(np.int64) | nb << 8 | run.astype(np.int64) << 31
    recs = np.stack([meta.astype(np.uint32).view(np.int32),
                     remap(c0),
                     np.where(one, remap(children[base + one]), line0),
                     f0], axis=1).astype(np.int32)

    L = int(nl.sum())
    node = np.repeat(np.arange(n), nl)          # the node of each line
    rank = 8 * (np.arange(L) - line0[node])[:, None] + np.arange(LINE)
    live = rank < nb[node][:, None]             # bounds 8L .. 8L+7
    lb = np.where(live, bounds[np.where(live, off[node][:, None] + rank,
                                        0)] if L else 0.0, np.nan)
    clive = rank + 1 <= nb[node][:, None]       # children 8L+1 .. 8L+8
    lc = np.where(clive, remap(children[np.where(
        clive, base[node][:, None] + rank + 1, 0)]), 0)
    lines = np.where(LINE_ORDER >= 0, lb[:, np.maximum(LINE_ORDER, 0)],
                     np.nan) if L else np.zeros((0, LINE))
    fn = np.repeat(np.arange(n), nf)            # the node of each fence
    fences = bounds[off[fn] + LINE * (np.arange(len(fn)) - f0[fn])]

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return PackedTree(tuple(map(put, (attr, bound_off, bounds, children))),
                      int(root),
                      put(recs), put(fences), put(lines),
                      put(lc.astype(np.int32)), depth)


# ------------------------------------------------------------ plain versions


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


def descend_batch_packed_plain(T, packed: PackedTree):
    """The kernel's walk in torch (any device), every row in lockstep.  A
    level reads the node's record and bisects its fences (its bounds ``0,
    8, 16, ...``) for ``F``, how many are ``<= v``.  ``F == 0`` (``v <
    b0``, a NaN, a bound-less node): ``child0``; at a one-bound node, else
    ``child1``; else line ``F - 1``: its bounds 3 and 6 give ``c0`` (how
    many are ``<= v``), the pair ``1 + c0`` of the line ``c1``, and ``p =
    8(F - 1) + 1 + 3 c0 + c1`` is the child: ``child0 - p`` where the
    children are the leaves ``~g0, ~(g0+1), ...``, else the line's.  NaN
    keys (padding) never count.  A path longer than the tree's node count
    raises, as the kernel traps."""
    m = T.shape[0]
    cur = torch.full((m,), packed.packed_root, dtype=torch.int64,
                     device=T.device)
    n = packed.num_nodes
    if n == 0:
        return ~cur
    recs = packed.recs.long()
    meta = recs[:, 0] & 0xFFFFFFFF
    attr, nb, run = meta & ATTR_MAX, (meta >> 8) & NB_MAX, (meta >> 31) == 1
    lb, lc = packed.lines, packed.kids.long()
    act = torch.nonzero(cur >= 0).flatten()
    levels = 0
    while act.numel():
        levels += 1
        if levels > n:
            raise RuntimeError("split_tree: a path longer than the tree's "
                               "node count (a corrupt tree)")
        nodes = cur[act]
        v = T[act, attr[nodes]]
        # bisect the node's fences: F = how many are <= v
        F = torch.zeros_like(nodes)
        hi = (nb[nodes] + LINE - 1) // LINE
        live = F < hi
        while bool(live.any()):
            mid = (F + hi) >> 1
            f = packed.fences[torch.where(live, recs[nodes, 3] + mid, 0)]
            take = live & (f <= v)
            F = torch.where(take, mid + 1, F)
            hi = torch.where(live & ~take, mid, hi)
            live = F < hi
        one = nb[nodes] == 1
        nxt = torch.where(F == 0, recs[nodes, 1], recs[nodes, 2])
        deep = torch.nonzero((F > 0) & ~one).flatten()
        if deep.numel():
            dn, dv, L = nodes[deep], v[deep], F[deep] - 1
            line = lb[recs[dn, 2] + L]
            c0 = (line[:, :2] <= dv[:, None]).sum(1)
            q = line.view(-1, LINE // 2, 2)[torch.arange(len(dn)), 1 + c0]
            cnt = 1 + 3 * c0 + (q <= dv[:, None]).sum(1)
            nxt[deep] = torch.where(run[dn], recs[dn, 1] - LINE * L - cnt,
                                    lc[recs[dn, 2] + L, cnt - 1])
        cur[act] = nxt
        act = act[nxt >= 0]
    return ~cur


# ------------------------------------------------------------------- kernel


class Plan(NamedTuple):
    """What one launch stages in shared memory: prefixes (breadth first)
    of the records, lines and fences, and the name of the choice."""
    recs: int
    lines: int
    fences: int
    staging: str

    @property
    def smem(self) -> int:
        return (self.recs * REC_BYTES + self.lines * LINE_BYTES
                + self.fences * FENCE_BYTES)


def plan(packed: PackedTree, budget: int = STAGE_BYTES) -> Plan:
    """The records, lines and fences of ``packed`` a block stages within
    ``budget`` bytes: the records first, then the fences, then the lines,
    each a prefix."""
    n, F, W = packed.num_nodes, packed.fences.numel(), packed.lines.shape[0]
    if packed.root < 0:
        return Plan(0, 0, 0, "unstaged")
    r = min(n, budget // REC_BYTES)
    left = budget - r * REC_BYTES
    f = w = 0
    if r == n:
        f = min(F, left // FENCE_BYTES)
        left -= f * FENCE_BYTES
        if f == F:
            w = min(W, left // LINE_BYTES)
    name = ("records prefix" if r < n else "records" if f < F
            else "records+fences" if w < W else "whole")
    return Plan(r, w, f, name)


def _launch(T, packed: PackedTree, p: Plan):
    """One launch of the kernel on ``T`` staging ``p``; returns the (m,)
    int64 leaves."""
    if p.smem > STAGE_MAX:
        raise ValueError(f"split_tree: {p.smem} bytes staged, more than "
                         f"the {STAGE_MAX} a block may take")
    m, k = T.shape
    out = torch.empty(m, dtype=torch.int64, device=T.device)
    vec = int(k % 2 == 0 and T.data_ptr() % 16 == 0)
    err = _build.load("split_tree", _SIG).split_tree_f64(
        T.data_ptr(), m, k, vec, packed.recs.data_ptr(),
        packed.fences.data_ptr(), packed.lines.data_ptr(),
        packed.kids.data_ptr(), packed.packed_root, packed.num_nodes,
        p.recs, p.fences, p.lines, out.data_ptr(),
        _build.stream_ptr(T.device))
    _build.check(err, "split_tree")
    return out


def _check_inputs(T, packed: PackedTree) -> None:
    if T.dtype != torch.float64 or T.dim() != 2 or not T.is_contiguous():
        raise ValueError("split_tree: T must be a contiguous (m, k) float64 "
                         "tensor")
    if packed.recs.device != T.device:
        raise ValueError(f"split_tree: the packed tree lies on "
                         f"{packed.recs.device}, T on {T.device}")


def descend_batch(T, packed: PackedTree):
    """(m,) int64 leaf ids of the rows of ``T`` (m, k) float64 down the
    tree ``packed`` (``SplitTree.device_packed``), on ``T``'s device.  One
    launch a call on the card (also for m = 0)."""
    global launches
    if T.device.type != "cuda":
        return descend_batch_plain(T, *packed.arrays, packed.root)
    _check_inputs(T, packed)
    out = _launch(T, packed, packed.staged)
    launches += 1
    return out


def descend_batch_bisect(T, packed: PackedTree):
    """The leaves of :func:`descend_batch` by the kernel the packed walk
    replaced (``csrc/split_tree_bisect.cu``, over ``packed.arrays``), on
    the device of ``T``: the baseline it is timed against.  No path of
    the port calls it, and it counts no launch."""
    if T.device.type != "cuda":
        return descend_batch_plain(T, *packed.arrays, packed.root)
    _check_inputs(T, packed)
    attr, off, bounds, children = packed.arrays
    out = torch.empty(T.shape[0], dtype=torch.int64, device=T.device)
    _build.check(_build.load("split_tree_bisect", _BISECT_SIG)
                 .split_tree_bisect_f64(
                     T.data_ptr(), T.shape[0], T.shape[1], attr.data_ptr(),
                     off.data_ptr(), bounds.data_ptr(), children.data_ptr(),
                     packed.root, packed.num_nodes, out.data_ptr(),
                     _build.stream_ptr(T.device)), "split_tree_bisect")
    return out
