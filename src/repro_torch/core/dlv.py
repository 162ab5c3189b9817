"""Dynamic Low Variance partitioning — paper §3 (Algorithms 5, 6, 7).

Port of ``repro.core.dlv``: the batched-frontier build (``dlv_rounds``,
the default) and the heap build (``dlv_heap``).

Every round of ``dlv_rounds`` selects all splittable partitions above
the total-variance bar (host numpy over the frontier, as in the
reference), then runs on the device: ONE gather of the selected spans,
ONE segmented stable sort, ONE Algorithm-5 cut scan over all spans
(``kernels.dlv_scan``: the CUDA kernel on the GPU, the reference's
float64 host scans as the plain version on the CPU), and ONE
segment-stats pass for the children's count / sum /
sum of squares (``kernels.segment_stats``).  ``X``, ``order``, the
gathers, the sort and the cuts stay on the device; each round copies its
cut values to the host once for the split tree.  ``finalize`` (exact
group reps and boxes) and the split-tree assembly stay host numpy.

``dlv_1d`` / ``dlv_1d_partition`` run the same scan on one sorted column
(on ``device``); ``ratio_score`` (Definition 2) is the reference's host
numpy metric.

``dlv(method="heap")`` is ``dlv_heap``, the original one-pop-per-iteration
build (the quality and benchmark baseline): the heap, each span's stable
argsort, the children's variances and the tree stay host numpy, line for
line the reference's, and each pop's scan runs on ``device`` through
``dlv_1d`` -- or, with ``scan="seed"``, through ``dlv_1d_seed``, the
seed's uncompensated scan (``kernels.dlv_scan.dlv_scan_seed``: on the
card a certified prefix-sum design, four kernels and one counted launch
a call for any span length).
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.distributed import mesh_device
from repro_torch.core.partitioner import (Partition, SplitTree, finalize,
                                          register_backend)
from repro_torch.device import resolve_device
from repro_torch.kernels.dlv_scan import dlv_scan, dlv_scan_seed
from repro_torch.kernels.segstats import segment_stats

# ------------------------------------------------------------- 1-D DLV


def _snap_cuts_to_run_starts(vals, cuts, seg_starts: np.ndarray):
    """Move each cut to the first element of its equal-value run (dropping
    cuts whose run begins a segment), on the tensors' device.

    The scan may place a delimiter mid-run of equal values, but a split
    boundary inside a run makes the split tree inconsistent with the
    stored gids (descent routes a value equal to the bound right while
    tied members sit left).  Snapping keeps every tied tuple on the right
    of its boundary; at most one cut per run exists, so snaps never
    collide.
    """
    n = len(vals)
    if not n or not bool(cuts.any()):
        return cuts
    dev = vals.device
    ss = torch.as_tensor(seg_starts, dtype=torch.int64, device=dev)
    change = torch.empty(n, dtype=torch.bool, device=dev)
    change[0] = True
    change[1:] = vals[1:] != vals[:-1]
    change[ss] = True
    ar = torch.arange(n, dtype=torch.int64, device=dev)
    run_start = torch.cummax(torch.where(change, ar, -1), 0).values
    pos = torch.nonzero(cuts).squeeze(1)
    tgt = run_start[pos]
    if torch.equal(tgt, pos):
        return cuts
    out = torch.zeros(n, dtype=torch.bool, device=dev)
    is_seg_start = torch.zeros(n, dtype=torch.bool, device=dev)
    is_seg_start[ss] = True
    out[tgt[~is_seg_start[tgt]]] = True
    return out


def _seg_cuts(vals_shifted, Ls, beta_seg, *, pitch: int = 256):
    """Delimiters (bool tensor) for many independent sorted segments,
    concatenated in the tensor ``vals_shifted`` with lengths ``Ls`` (each
    centred on its own mean) and bars ``beta_seg`` (host arrays): one
    ``dlv_scan`` over all segments, then cuts snapped to equal-value run
    starts.  ``pitch`` (~d_f) steers the plain version's scan choice."""
    n = len(vals_shifted)
    Ls = np.asarray(Ls, np.int64)
    if n == 0 or not len(Ls):
        return torch.zeros(n, dtype=torch.bool, device=vals_shifted.device)
    starts = np.concatenate([[0], np.cumsum(Ls)[:-1]])
    cuts = dlv_scan(vals_shifted, Ls, np.asarray(beta_seg, np.float64),
                    pitch=pitch)
    return _snap_cuts_to_run_starts(vals_shifted, cuts, starts)


def dlv_1d(values: np.ndarray, beta: float, device="cuda") -> np.ndarray:
    """Delimiter positions for sorted ``values``; returns cut flags (n,)
    (host numpy), the scan run on ``device``."""
    dev = resolve_device(device)
    v = np.asarray(values, np.float64)
    n = len(v)
    if n == 0:
        return np.zeros(0, bool)
    shift = v.mean()         # center: keeps the low-precision path accurate
    vals = torch.as_tensor(v - shift, dtype=torch.float64, device=dev)
    return _seg_cuts(vals, np.array([n]),
                     np.array([float(beta)])).cpu().numpy()


def dlv_1d_seed(values: np.ndarray, beta: float,
                device="cuda") -> np.ndarray:
    """The seed build's per-span scan: cut flags (n,) (host numpy) of the
    uncompensated running-variance scan of sorted ``values``, shifted by
    their mean, run on ``device``; no cut at row 0 and no snapping to
    equal-value run starts, as in the seed."""
    dev = resolve_device(device)
    v = np.asarray(values, np.float64)
    if not len(v):
        return np.zeros(0, bool)
    shift = v.mean()
    vals = torch.as_tensor(v - shift, dtype=torch.float64, device=dev)
    cuts = dlv_scan_seed(vals, float(beta)).cpu().numpy()
    cuts[0] = False
    return cuts


def dlv_1d_partition(values: np.ndarray, beta: float, device="cuda"):
    """(group_id per element, boundary values d_1..d_{p-1}) for sorted
    input."""
    cuts = dlv_1d(values, beta, device=device)
    gid = np.cumsum(cuts)
    bounds = values[np.flatnonzero(cuts)]
    return gid, bounds


def ratio_score(values: np.ndarray, gid: np.ndarray, *,
                weighted: bool = False) -> float:
    """Definition 2: sum of per-partition variances / total variance.

    Single vectorised host pass: per-group count/sum/sum-of-squares via
    ``np.bincount`` (O(n + G)).  Sparse / negative / non-integer ids are
    compacted with ONE ``np.unique`` call.  ``weighted=True`` weights each
    group's variance by its share of tuples (the within-group variance
    fraction, in [0, 1])."""
    values = np.asarray(values, np.float64)
    tot = float(np.var(values))
    if tot <= 0:
        return 0.0
    gid = np.asarray(gid)
    if gid.dtype.kind not in "iu" or (
            len(gid) and (gid.min() < 0 or gid.max() >= len(gid))):
        gid = np.unique(gid, return_inverse=True)[1]
    shift = values.mean()              # numerical stabilisation
    v = values - shift
    cnt = np.bincount(gid)
    s1 = np.bincount(gid, weights=v)
    s2 = np.bincount(gid, weights=v * v)
    nz = cnt > 0
    var_g = np.maximum(s2[nz] / cnt[nz] - (s1[nz] / cnt[nz]) ** 2, 0.0)
    if weighted:
        return float((var_g * cnt[nz]).sum() / len(values)) / tot
    return float(var_g.sum()) / tot


# ------------------------------------------------------ GetScaleFactors


def get_scale_factors(X: np.ndarray, d_f: int, *, sample: int = 10_000,
                      eps: float = 1e-9, max_steps: int = 60,
                      rng: Optional[np.random.Generator] = None,
                      device="cuda") -> np.ndarray:
    """Algorithm 7: per-attribute constants c_j with beta = c_j sigma^2/d_f^2.

    All attributes' binary searches advance in lock-step: each iteration
    runs ONE scan over the k sorted sample columns with per-attribute
    betas (on ``device``)."""
    dev = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    n, k = X.shape
    take = min(sample, n)
    idx = rng.choice(n, size=take, replace=False) if take < n else np.arange(n)
    V = np.sort(X[idx], axis=0)                  # per-column sorted sample
    Vc = V - V.mean(axis=0)
    var = V.var(axis=0)
    out = np.full(k, 13.5)                       # paper's default c
    searching = var > 0
    lo = np.zeros(k)
    hi = 0.25 * (V[-1] - V[0]) ** 2
    beta = hi.copy()
    target = max(2, min(d_f, take))
    vflat = torch.as_tensor(np.ascontiguousarray(Vc.T.reshape(-1)),
                            dtype=torch.float64, device=dev)
    Lk = np.full(k, take, np.int64)
    for _ in range(max_steps):
        run = searching & (hi - lo > eps * np.maximum(hi, 1.0))
        if not run.any():
            break
        beta = np.where(run, 0.5 * (lo + hi), beta)
        B = np.where(run, beta, np.inf)          # frozen columns never cut
        p = _seg_cuts(vflat, Lk, B).reshape(k, take).sum(
            dim=1).cpu().numpy() + 1
        searching &= ~(run & (p == target))      # converged exactly
        hi = np.where(run & (p < target), beta, hi)
        lo = np.where(run & (p > target), beta, lo)
    pos = var > 0
    out[pos] = beta[pos] * d_f * d_f / var[pos]
    return out


# ----------------------------------------------------------- split nodes


class SplitNode:
    """Pointer-tree node used only while a build runs; converted to the
    flat :class:`SplitTree` arrays at finalization."""

    __slots__ = ("attr", "bounds", "children")

    def __init__(self, attr: int, bounds: np.ndarray, children: List[int]):
        self.attr = attr
        self.bounds = bounds
        self.children = children


def _tree_from_nodes(nodes: List[SplitNode], root: int) -> SplitTree:
    if root < 0 or not nodes:
        return SplitTree.single_leaf()
    attr = np.fromiter((nd.attr for nd in nodes), np.int32, len(nodes))
    nb = np.fromiter((len(nd.bounds) for nd in nodes), np.int64, len(nodes))
    bound_off = np.concatenate([[0], np.cumsum(nb)])
    bounds = np.concatenate([nd.bounds for nd in nodes]) \
        if bound_off[-1] else np.zeros(0, np.float64)
    children = np.concatenate([np.asarray(nd.children, np.int64)
                               for nd in nodes])
    return SplitTree(attr, bound_off, np.asarray(bounds, np.float64),
                     children, root)


# -------------------------------------------------------- heap-based build


_PID_TAG = 1 << 40   # children >= _PID_TAG are unresolved leaf pids


def dlv_heap(X: np.ndarray, d_f: int, *, c: Optional[np.ndarray] = None,
             min_groups: Optional[int] = None,
             rng: Optional[np.random.Generator] = None,
             scan: str = "fast", mesh=None,
             chunk_rows: Optional[int] = None,
             time_budget_s: Optional[float] = None,
             device="cuda") -> Partition:
    """Algorithm 6, one heap pop (= one split) per iteration.

    The reference build the batched ``dlv_rounds`` is validated against;
    O(G) python iterations, each with its own span argsort (host) and
    scan (on ``device``).  ``scan="seed"`` runs the seed's scan
    (``dlv_1d_seed``) in place of ``dlv_1d``; ``time_budget_s`` raises
    TimeoutError mid-build when exceeded; ``chunk_rows`` and ``mesh`` go
    to the final group stats (``partitioner.group_stats``)."""
    import time as _time
    t0 = _time.time()
    if mesh is not None:
        mesh_device(mesh, device)
    dev = resolve_device(device)
    scan_1d = dlv_1d_seed if scan == "seed" else dlv_1d
    X = np.asarray(X, np.float64)
    n, k = X.shape
    target = min_groups if min_groups is not None else max(1, n // d_f)
    if c is None:
        c = get_scale_factors(X, d_f, rng=rng, device=dev)

    order = np.arange(n)
    spans: Dict[int, Tuple[int, int]] = {0: (0, n)}
    var_cache: Dict[int, np.ndarray] = {0: np.var(X, axis=0)}
    next_pid = 1
    heap: List[Tuple[float, int]] = []

    def push(pid):
        s, e = spans[pid]
        tv = (e - s) * float(var_cache[pid].max())
        if e - s >= 2 and tv > 0:
            heapq.heappush(heap, (-tv, pid))

    push(0)
    nodes: List[SplitNode] = []
    child_slot: Dict[int, Tuple[int, int]] = {}   # pid -> (node_id, slot)
    root = -1

    while len(spans) < target and heap:
        if time_budget_s is not None and _time.time() - t0 > time_budget_s:
            raise TimeoutError(f"dlv_heap(scan={scan!r}) exceeded "
                               f"{time_budget_s}s at {len(spans)} groups")
        _, pid = heapq.heappop(heap)
        if pid not in spans:
            continue
        s, e = spans[pid]
        v = var_cache[pid]
        j = int(np.argmax(v))
        sigma2 = float(v[j])
        if sigma2 <= 0:
            continue
        beta = c[j] * sigma2 / (d_f * d_f)
        idx = order[s:e]
        vals = X[idx, j]
        perm = np.argsort(vals, kind="stable")
        idx = idx[perm]
        vals = vals[perm]
        cuts = scan_1d(vals, beta, device=dev)
        p = int(cuts.sum()) + 1
        tries = 0
        while p == 1 and tries < 30:
            beta *= 0.25
            cuts = scan_1d(vals, beta, device=dev)
            p = int(cuts.sum()) + 1
            tries += 1
        if p == 1:
            continue  # unsplittable (all-equal values)
        order[s:e] = idx
        bpos = np.flatnonzero(cuts)
        starts = np.concatenate([[0], bpos, [e - s]])
        node_id = len(nodes)
        node = SplitNode(j, vals[bpos], [])
        nodes.append(node)
        if pid in child_slot:
            pn, slot = child_slot[pid]
            nodes[pn].children[slot] = node_id
        elif root == -1:
            root = node_id
        del spans[pid]
        del var_cache[pid]
        for i in range(len(starts) - 1):
            cs, ce = s + int(starts[i]), s + int(starts[i + 1])
            cp = next_pid
            next_pid += 1
            spans[cp] = (cs, ce)
            var_cache[cp] = np.var(X[order[cs:ce]], axis=0) if ce - cs > 1 \
                else np.zeros(k)
            node.children.append(_PID_TAG + cp)
            child_slot[cp] = (node_id, i)
            push(cp)

    # compact group ids in slice order; resolve tagged leaf pids to ~gid
    pids = sorted(spans, key=lambda p: spans[p][0])
    offsets = np.fromiter((spans[p][0] for p in pids), np.int64, len(pids))
    offsets = np.concatenate([offsets, [n]])
    pid_to_gid = {p: g for g, p in enumerate(pids)}
    for node in nodes:
        node.children = [
            ~pid_to_gid[ch - _PID_TAG] if ch >= _PID_TAG else ch
            for ch in node.children]
    return finalize(X, order, offsets, _tree_from_nodes(nodes, root),
                    mesh=mesh, chunk_rows=chunk_rows)


# ----------------------------------------------- batched frontier rounds


def dlv_rounds(X: np.ndarray, d_f: int, *, c: Optional[np.ndarray] = None,
               min_groups: Optional[int] = None,
               rng: Optional[np.random.Generator] = None,
               mesh=None, chunk_rows: Optional[int] = None,
               log: Optional[list] = None, device="cuda") -> Partition:
    """Algorithm 6 as batched frontier rounds (see module docstring).

    Same rounds, selection rule and tree as the reference; ``log``
    (optional list) receives one dict per round; ``chunk_rows`` runs the
    final group stats chunk by chunk (``partitioner.group_stats``), with
    ``mesh`` sharded over its leading dim."""
    import time as _time
    t0 = _time.time()
    if mesh is not None:
        mesh_device(mesh, device)
    dev = resolve_device(device)
    X = np.asarray(X, np.float64)
    n, k = X.shape
    target = min_groups if min_groups is not None else max(1, n // d_f)
    if c is None:
        c = get_scale_factors(X, d_f, rng=rng, device=dev)
    gshift = X.mean(axis=0)
    Xd = torch.as_tensor(X, dtype=torch.float64, device=dev)
    gshift_d = torch.as_tensor(gshift, dtype=torch.float64, device=dev)

    def tens(a, dtype=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    order = torch.arange(n, dtype=torch.int64, device=dev)
    # frontier state (one row per live partition), host numpy
    S = np.zeros(1, np.int64)
    E = np.full(1, n, np.int64)
    Xc0 = X - gshift
    SU = Xc0.sum(axis=0, keepdims=True)            # (P, k) centered sums
    SQ = (Xc0 * Xc0).sum(axis=0, keepdims=True)    # (P, k) centered sumsqs
    frozen = np.zeros(1, bool)
    del Xc0
    pid = np.zeros(1, np.int64)                    # tree linkage handles
    next_pid = 1

    nodes: List[SplitNode] = []
    child_slot: Dict[int, Tuple[int, int]] = {}
    root = -1
    avg_children = float(max(2, min(d_f, n)))      # round-1 estimate

    while len(S) < target:
        cnt = (E - S).astype(np.float64)
        var = np.maximum(SQ / cnt[:, None] - (SU / cnt[:, None]) ** 2, 0.0)
        vmax = var.max(axis=1)
        jbest = var.argmax(axis=1)
        tv = cnt * vmax
        cand = np.flatnonzero((cnt >= 2) & (tv > 0) & ~frozen)
        if not len(cand):
            break
        remaining = target - len(S)
        take = max(1, int(np.ceil(remaining / max(avg_children - 1.0, 1.0))))
        if len(cand) > take:
            # the total-variance bar: the take-th largest tv among candidates
            sel = cand[np.argpartition(-tv[cand], take - 1)[:take]]
        else:
            sel = cand
        nseg = len(sel)
        Ls = (E - S)[sel]
        total = int(Ls.sum())
        seg_off = np.concatenate([[0], np.cumsum(Ls)])
        Ls_d = tens(Ls)

        def per_row(v, dtype=torch.int64):
            return torch.repeat_interleave(tens(v, dtype), Ls_d,
                                           output_size=total)

        segid = per_row(np.arange(nseg))
        pos = per_row(S[sel] - seg_off[:-1]) + torch.arange(
            total, dtype=torch.int64, device=dev)
        idxc = order[pos]
        vals = Xd[idxc, per_row(jbest[sel])]
        # segmented stable sort: by value, then stably by segment -- per
        # span exactly np.argsort(kind="stable")
        p1 = torch.sort(vals, stable=True).indices
        perm = p1[torch.sort(segid[p1], stable=True).indices]
        idxs = idxc[perm]
        vals_s = vals[perm]

        # per-segment center (raw partition mean on the split attribute)
        mean_sel = SU[sel, jbest[sel]] / Ls + gshift[jbest[sel]]
        beta_sel = c[jbest[sel]] * vmax[sel] / (d_f * d_f)
        vs = vals_s - per_row(mean_sel, torch.float64)
        cuts = _seg_cuts(vs, Ls, beta_sel, pitch=d_f)

        # segments that produced no delimiter retry with beta/4 (the heap
        # build's rule); all-equal segments can never split -> frozen
        def count_cuts():
            return torch.bincount(segid[cuts], minlength=nseg).cpu().numpy()

        ncuts = count_cuts()
        so = tens(seg_off)
        alleq = (vals_s[so[1:] - 1] == vals_s[so[:-1]]).cpu().numpy()
        fail = np.flatnonzero((ncuts == 0) & ~alleq)
        tries = 0
        while len(fail) and tries < 30:
            beta_sel[fail] *= 0.25
            fmask = np.zeros(nseg, bool)
            fmask[fail] = True
            elm = tens(fmask, torch.bool)[segid]
            cuts[elm] = _seg_cuts(vs[elm], Ls[fail], beta_sel[fail],
                                  pitch=d_f)
            ncuts = count_cuts()
            fail = np.flatnonzero((ncuts == 0) & ~alleq)
            tries += 1

        order[pos] = idxs                          # spans are now sorted
        split = np.flatnonzero(ncuts > 0)
        if not len(split):
            frozen[sel] = True
            continue
        frozen[sel[ncuts == 0]] = True
        # accept splits in total-variance order only until the target is
        # reached (the heap build's stop rule, applied batch-wise)
        split = split[np.argsort(-tv[sel[split]], kind="stable")]
        gain = np.cumsum(ncuts[split])             # children-1 per split
        need = target - len(S)
        split = split[:int(np.searchsorted(gain, need, side="left")) + 1]
        split.sort()

        # contiguous child ids across the concatenated array
        boundary = cuts.clone()
        boundary[so[:-1]] = True
        cid = torch.cumsum(boundary, 0) - 1
        bpos_d = torch.nonzero(boundary).squeeze(1)
        bpos = bpos_d.cpu().numpy()
        n_children = len(bpos)
        ccnt = np.diff(np.concatenate([bpos, [total]])).astype(np.float64)
        child_start = pos[bpos_d].cpu().numpy()    # order slot of each child
        # the round's cut values, copied to the host once
        cpos = torch.nonzero(cuts).squeeze(1)
        cut_vals = vals_s[cpos].cpu().numpy()
        cut_off = np.searchsorted(segid[cpos].cpu().numpy(),
                                  np.arange(nseg + 1))

        # tree nodes for the split partitions (python loop is O(#splits)
        # with list appends only — no numeric work)
        keep = np.ones(len(S), bool)
        new_rows = []                              # frontier child row ranges
        cstart_of_seg = np.searchsorted(bpos, seg_off[:-1])
        for si in split:
            i = sel[si]
            keep[i] = False
            c0, c1 = cstart_of_seg[si], (cstart_of_seg[si + 1]
                                         if si + 1 < nseg else n_children)
            bvals = cut_vals[cut_off[si]:cut_off[si + 1]]
            node_id = len(nodes)
            node = SplitNode(int(jbest[i]), bvals, [])
            nodes.append(node)
            p = int(pid[i])
            if p in child_slot:
                pn, slot = child_slot[p]
                nodes[pn].children[slot] = node_id
                del child_slot[p]
            elif root == -1:
                root = node_id
            for ci in range(c0, c1):
                cp = next_pid
                next_pid += 1
                node.children.append(_PID_TAG + cp)
                child_slot[cp] = (node_id, ci - c0)
            new_rows.append((c0, c1, next_pid - (c1 - c0)))

        # frontier update: drop split rows, append their children
        ch_sel = np.concatenate([np.arange(c0, c1) for c0, c1, _ in new_rows])
        ch_pid = np.concatenate([np.arange(p0, p0 + (c1 - c0))
                                 for c0, c1, p0 in new_rows])
        ch_cnt = ccnt[ch_sel].astype(np.int64)
        # children sums/sumsqs feed the NEXT round's selection; the final
        # round skips the pass and lets finalize recompute exact reps
        done = int(keep.sum()) + len(ch_sel) >= target
        if done:
            csum = np.zeros((n_children, k))
            csq = np.zeros((n_children, k))
        else:
            _, csum_d, csq_d = segment_stats(
                (Xd[idxs] - gshift_d).contiguous(), cid, n_children)
            csum, csq = csum_d.cpu().numpy(), csq_d.cpu().numpy()
        ch_S = child_start[ch_sel]
        S = np.concatenate([S[keep], ch_S])
        E = np.concatenate([E[keep], ch_S + ch_cnt])
        SU = np.concatenate([SU[keep], csum[ch_sel]])
        SQ = np.concatenate([SQ[keep], csq[ch_sel]])
        frozen = np.concatenate([frozen[keep], ch_cnt <= 1])
        pid = np.concatenate([pid[keep], ch_pid])
        avg_children = len(ch_sel) / max(len(split), 1)
        if log is not None:
            log.append({"round": len(log), "groups": int(len(S)),
                        "selected": int(nseg), "split": int(len(split)),
                        "children": int(len(ch_sel)),
                        "t": _time.time() - t0})
        if done:
            break

    # finalize: groups in slice order, unresolved leaf pids -> ~gid
    gorder = np.argsort(S, kind="stable")
    offsets = np.concatenate([S[gorder], [n]])
    pid_to_gid = {int(pid[r]): g for g, r in enumerate(gorder)}
    for node in nodes:
        node.children = [
            ~pid_to_gid[ch - _PID_TAG] if ch >= _PID_TAG else ch
            for ch in node.children]
    return finalize(X, order.cpu().numpy(), offsets,
                    _tree_from_nodes(nodes, root), mesh=mesh,
                    chunk_rows=chunk_rows)


# ------------------------------------------------------------- entry point


@register_backend("dlv")
def dlv(X: np.ndarray, d_f: int = 100, *, c: Optional[np.ndarray] = None,
        min_groups: Optional[int] = None,
        rng: Optional[np.random.Generator] = None,
        method: str = "rounds", device="cuda", **kwargs) -> Partition:
    """Algorithm 6 over tuples X (n, k); produces ~n/d_f groups."""
    if method == "rounds":
        return dlv_rounds(X, d_f, c=c, min_groups=min_groups, rng=rng,
                          device=device, **kwargs)
    if method == "heap":
        # forward everything: unknown options raise instead of silently
        # configuring nothing
        return dlv_heap(X, d_f, c=c, min_groups=min_groups, rng=rng,
                        device=device, **kwargs)
    raise ValueError(f"unknown dlv method {method!r}")
