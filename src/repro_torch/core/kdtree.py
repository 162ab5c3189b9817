"""KD-TREE partitioning as used by SketchRefine (Brucato et al. [5]) --
the baseline DLV is compared against (paper §3.3, Mini-Exp 5, Fig. 7);
port of ``repro.core.kdtree``.

A cluster is split (on its widest-variance attribute, at the mean) while
(1) |P| > size threshold tau, or (2) radius > omega.  Produces the same
:class:`~repro_torch.core.partitioner.Partition` as every other backend:
the binary mean-splits are recorded into the flat split tree (each node has
one boundary, two children).  The build is host numpy, as the reference's
is on every platform.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core.partitioner import (Partition, SplitTree, finalize,
                                          register_backend)
from repro_torch.device import resolve_device


def kdtree_partition(X: np.ndarray, *, tau: int, omega: float = np.inf,
                     max_groups: int = 1 << 20) -> Partition:
    X = np.asarray(X, np.float64)
    n, k = X.shape
    attrs: List[int] = []              # flat tree under construction
    mus: List[float] = []
    children: List[List[int]] = []
    root = -1
    # stack / finalized entries carry their (parent node, child slot)
    stack: List[Tuple[np.ndarray, int, int]] = [(np.arange(n), -1, -1)]
    final: List[Tuple[np.ndarray, int, int]] = []
    while stack and len(stack) + len(final) < max_groups:
        idx, pn, slot = stack.pop()
        sub = X[idx]
        radius = np.abs(sub - sub.mean(0)).max() if len(idx) else 0.0
        if len(idx) <= 1 or (len(idx) <= tau and radius <= omega):
            final.append((idx, pn, slot))
            continue
        j = int(np.argmax(sub.var(0)))
        mu = sub[:, j].mean()
        left = idx[sub[:, j] < mu]
        right = idx[sub[:, j] >= mu]
        if len(left) == 0 or len(right) == 0:
            final.append((idx, pn, slot))  # degenerate: all equal to mean side
            continue
        node_id = len(attrs)
        attrs.append(j)
        mus.append(mu)
        children.append([-1, -1])
        if pn >= 0:
            children[pn][slot] = node_id
        elif root == -1:
            root = node_id
        stack.append((left, node_id, 0))    # descent: t[j] < mu -> slot 0
        stack.append((right, node_id, 1))
    final.extend(stack)

    order = np.concatenate([f[0] for f in final]) if final \
        else np.zeros(0, np.int64)
    lens = np.fromiter((len(f[0]) for f in final), np.int64, len(final))
    offsets = np.concatenate([[0], np.cumsum(lens)])
    for g, (_, pn, slot) in enumerate(final):
        if pn >= 0:
            children[pn][slot] = ~g
    if root == -1:
        tree = SplitTree.single_leaf()
    else:
        N = len(attrs)
        tree = SplitTree(np.asarray(attrs, np.int32),
                         np.arange(N + 1, dtype=np.int64),
                         np.asarray(mus, np.float64),
                         np.asarray(children, np.int64).reshape(-1), root)
    return finalize(X, order, offsets, tree)


@register_backend("kdtree")
def _kdtree_backend(X, *, tau: int = None, d_f: int = None,
                    omega: float = np.inf, max_groups: int = 1 << 20,
                    rng=None, mesh=None, chunk_rows: int = None,
                    device="cuda") -> Partition:
    """Partitioner backend: ``tau`` defaults to ``d_f`` (target group size).
    ``rng`` is accepted for signature uniformity (the build is
    deterministic).  The build is host numpy whatever ``device`` says:
    ``device`` is accepted so that ``Hierarchy`` can pass it, and checked
    like every entry point's (CUDA asked for and absent raises).  Sharded
    or chunked stats are not implemented here -- asking for them raises
    instead of silently running fully in memory."""
    if mesh is not None or chunk_rows is not None:
        raise TypeError("kdtree backend does not support mesh/chunk_rows "
                        "(sharded group stats); use backend='dlv' or "
                        "'bucketing'")
    resolve_device(device)
    if tau is None:
        tau = d_f if d_f is not None else 100
    return kdtree_partition(np.asarray(X), tau=tau, omega=omega,
                            max_groups=max_groups)


# Back-compat: old callers imported KDResult; a Partition is the same shape.
KDResult = Partition
