"""Distributed pricing backend for the revised dual simplex (port of
``repro.core.distributed``) on ``torch.distributed``: the paper's
Parallel Dual Simplex (Mini-Exp 3) with the tuple columns sharded over
the ranks of a ``DeviceMesh`` (``solve_lp_dist`` / ``solve_lp(mesh=)``).

The reference is single-controller (one process drives every device
through ``shard_map``); ``torch.distributed`` is multi-controller.  Every
rank calls the same entry point with the same host inputs:

* A, the MAINTAINED reduced costs ``d``, the bounds and the nonbasic
  position codes are column-sharded: rank ``r`` holds columns
  ``[r n_loc, (r + 1) n_loc)`` of the padded ``Npad = ceil(N / p) p``,
  ``r`` the row-major index over the mesh dims (the reference's
  ``_my_rank``), on the rank's device, across pivots;
* the m x m basis state (Binv, y, xB, basis) is host numpy, replicated
  on every rank and kept bit-identical: each decision is taken from
  collective outputs and identical host inputs, so the ranks issue the
  same collectives and return the same ``LPResult``.

Three steps a pivot, as in the reference:

``pq_step``   -- pricing + BFRT selection.  Per rank:
  1. pricing: ``kernels.pricing.Pricer`` (``csrc/pricing.cu`` on a card),
     the lone O(m n/p) sweep of A; ``d`` arrives maintained;
  2. BFRT pass 1: ``kernels.bfrt.bfrt_histogram`` (``csrc/bfrt.cu``) over
     edges from the global ratio range;
  3. SUM of the histograms, the crossing bucket;
  4. pass 2: each rank's K smallest in-bucket breakpoints, one
     all-gather of the (p, K) candidate block, and the replicated exact
     merge; a rank holding more than K in-bucket breakpoints below the
     crossing point (detected) makes the pivot the conservative one at
     the bucket minimum.
  Four collectives a pivot: a MAX of (rmax, -rmin), a SUM of the
  histogram, the all-gather of the packed candidates with each rank's
  truncation word and K-th ratio, and a SUM of ``[fvec, Acol, n_flips]``:
  O(num_buckets + p K + m) bytes.  The host reads one packed tensor a
  pivot; alpha and the flip mask stay on the device for the update.

``update_step`` -- ``d -= theta alpha`` plus the bound-flip and
  basis-exchange bookkeeping; shard-local, no collective.

``refresh_step`` -- every ``REFACTOR_EVERY`` pivots: ``d = c - y A``
  from fresh duals and a SUM of ``A xN`` for the basic-value rebuild.

The build passes (``partitioner.group_stats``, ``bucketing``'s stats and
counting passes) shard rows over the mesh's leading dim and reduce over
that dim's group (:func:`row_shards`).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dims are
named from ``("pod", "data", "model")`` in that order, built over the
whole world by ``init_device_mesh``: ``gloo`` on the CPU (callers pass
``device="cpu"``), NCCL on the card.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels.bfrt import bfrt_histogram
from repro_torch.kernels.pricing import Pricer, ratio_range_plain
from repro_torch.runtime import racecheck

NUM_BUCKETS = 128
GATHER_K = 128        # per-rank in-bucket candidates for the exact walk
_TOL = 1e-9
WIDTH_CAP = 1e30      # stand-in for infinite bound widths (flip cost = huge)
MESH_AXES = ("pod", "data", "model")
_FIELDS = 6           # a candidate's words: ratio, cost, d, at_up, valid, g
# the replicated outputs' slots in the packed tensor the host reads
R_BEST, Q, D_Q, AT_UP_Q, N_FLIPS, HAS_CROSS, EXACT, ACOL = range(8)


def big_sentinel(dtype):
    """Largest finite value of ``dtype`` (a 0-d tensor): the sentinel of
    the masked min/max reductions, finite in every dtype."""
    return torch.tensor(torch.finfo(dtype).max, dtype=dtype)


# ------------------------------------------------------------ mesh helpers


def _check_mesh(mesh) -> None:
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError("mesh= takes a torch.distributed.device_mesh."
                        f"DeviceMesh, got {type(mesh).__name__}")


def mesh_device(mesh, expected=None) -> torch.device:
    """This rank's device on ``mesh``: its current CUDA device on a
    ``"cuda"`` mesh, the CPU on a ``"cpu"`` one.  The ``device`` that a
    caller gave beside the mesh (``expected``) must name the same type
    (``ValueError``): there is no silent CPU run."""
    _check_mesh(mesh)
    kind = mesh.device_type
    if kind == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    elif kind == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"unsupported mesh device type {kind!r}")
    if expected is not None and torch.device(expected).type != kind:
        raise ValueError(f"device {str(expected)!r} disagrees with the "
                         f"mesh's device type {kind!r}")
    return dev


@dataclasses.dataclass(frozen=True)
class ColumnShards:
    """The pricing layout of a mesh: ``p`` ranks, this one ``rank`` (the
    row-major index over the mesh dims).  Its collectives run over the
    default group (which the mesh spans) as it stands at each call: a
    cached step outlives the group it was built under when the caller
    makes a new one."""
    p: int
    rank: int
    device: torch.device


def column_shards(mesh) -> ColumnShards:
    """Columns are sharded over every rank of ``mesh`` (the reference's
    ``P(None, axes)`` over all its data axes)."""
    dev = mesh_device(mesh)
    names = tuple(mesh.mesh_dim_names or ())
    if len(names) != mesh.ndim or names != tuple(
            a for a in MESH_AXES if a in names):
        raise ValueError(f"mesh dims must be named from {MESH_AXES} in that "
                         f"order, got {names}")
    ranks = mesh.mesh.flatten().tolist()
    if ranks != list(range(dist.get_world_size())):
        raise ValueError("the mesh must span the world in rank order, as "
                         "init_device_mesh builds it")
    return ColumnShards(len(ranks), dist.get_rank(), dev)


@dataclasses.dataclass(frozen=True)
class RowShards:
    """The build passes' layout: rows split over ``nd`` shards of the
    mesh's leading dim, this rank's shard ``index``, sums over ``group``
    (ranks that share a leading index compute the same values)."""
    nd: int
    index: int
    group: object
    device: torch.device

    def take(self, rows: np.ndarray, per: int, fill) -> np.ndarray:
        """This shard's ``per`` rows of ``rows`` padded to ``nd * per``
        rows with ``fill``."""
        part = rows[self.index * per:(self.index + 1) * per]
        out = np.full((per,) + rows.shape[1:], fill, np.asarray(rows).dtype)
        out[:len(part)] = part
        return out


def row_shards(mesh) -> RowShards:
    dev = mesh_device(mesh)
    return RowShards(mesh.size(0), mesh.get_coordinate()[0],
                     mesh.get_group(0), dev)


def _all_gather(out, t) -> None:
    """``t`` of every rank of the default group, in rank order, into the
    flat ``out``."""
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, t)


def _first_true(mask):
    """Index of the first True (0 if none), a 1-element tensor: never a
    0-d one, which torch turns into a Python int (a host sync)."""
    return torch.argmax(mask.to(torch.int32)).reshape(1)


# ------------------------------------------------------------- the steps


class PQStep:
    """The distributed pricing + BFRT-selection step (the reference's
    ``make_pq_step``): see :func:`make_pq_step`."""

    def __init__(self, shards: ColumnShards, m: int, n: int,
                 num_buckets: int, gather_k: int):
        if n % shards.p:
            raise ValueError(f"n={n} is not a multiple of the {shards.p} "
                             "column shards")
        self.shards, self.m, self.n = shards, int(m), int(n)
        self.n_loc = self.n // shards.p
        self.num_buckets = int(num_buckets)
        self.k = min(int(gather_k), self.n_loc)

    def bind(self, A_loc, l_loc, u_loc) -> "BoundPQStep":
        """The step against one solve's loop constants (this rank's A and
        bounds), checked once: each call then takes a pivot's inputs."""
        return BoundPQStep(self, A_loc, l_loc, u_loc)

    def __call__(self, A_loc, d_loc, l_loc, u_loc, state_loc, rho, s,
                 budget):
        """``(alpha, flip_mask, r_best, q, d_q, at_up_q, Acol, fvec,
        n_flips, has_cross, exact)``: alpha and the flip mask this rank's
        shard, the rest replicated (q int64, the flags bool)."""
        alpha, flips, rep = self.bind(A_loc, l_loc, u_loc)(
            d_loc, state_loc, rho, s, budget)
        dt, m = alpha.dtype, self.m
        return (alpha, flips, rep[R_BEST].to(dt), rep[Q].to(torch.int64),
                rep[D_Q].to(dt), rep[AT_UP_Q] > 0,
                rep[ACOL:ACOL + m].to(dt), rep[ACOL + m:].to(dt),
                rep[N_FLIPS].to(torch.int64), rep[HAS_CROSS] > 0,
                rep[EXACT] > 0)


class BoundPQStep:
    """A :class:`PQStep` bound to one solve's ``A_loc`` (m, n_loc) and
    bounds: one ``Pricer`` (lo = 0, hi = the width capped at
    ``WIDTH_CAP``, so its flip cost is the reference's
    ``|alpha| * width``).  A call returns ``(alpha, flip_mask, rep)``,
    ``rep`` the replicated outputs packed in float64 (slots ``R_BEST`` ..
    ``EXACT``, then Acol and fvec): the host reads it with one copy."""

    def __init__(self, step: PQStep, A_loc, l_loc, u_loc):
        sh = step.shards
        if tuple(A_loc.shape) != (step.m, step.n_loc):
            raise ValueError(f"A_loc must be ({step.m}, {step.n_loc}), got "
                             f"{tuple(A_loc.shape)}")
        if A_loc.device != sh.device:
            raise ValueError(f"A_loc lies on {A_loc.device}, the mesh's "
                             f"rank on {sh.device}")
        self.step, self.A = step, A_loc
        width = u_loc - l_loc
        self.width = torch.where(torch.isfinite(width), width, WIDTH_CAP)
        self.price = Pricer(A_loc, torch.zeros_like(self.width), self.width)
        dt, dev = A_loc.dtype, A_loc.device
        self.big = float(big_sentinel(dt))
        nb = step.num_buckets
        # the reference's edge grid, in the pricing dtype
        self.grid = torch.arange(1, nb + 1, dtype=dt, device=dev) / nb
        self.inf = torch.full((1,), float("inf"), dtype=dt, device=dev)
        self.ik = torch.arange(step.k, device=dev)
        self.im = torch.arange(sh.p * step.k, device=dev)

    def __call__(self, d_loc, state_loc, rho, s, budget):
        st, sh = self.step, self.step.shards
        k, n_loc, big = st.k, st.n_loc, self.big
        A, dt, dev = self.A, self.A.dtype, self.A.device
        rho = torch.as_tensor(rho, dtype=dt, device=dev)
        alpha, ratio, cost, rng = self.price(rho, d_loc, state_loc, s)
        if rng is None:                       # the float32 route
            rng = ratio_range_plain(ratio)
        finite = torch.isfinite(ratio)

        # ---- BFRT pass 1: edges from the global range, one MAX ----
        # pricing's range words (a NaN min without a finite ratio, the max
        # taken with 0) as the reference's masked reductions give them
        none = torch.isnan(rng[:1])
        ext = torch.cat([torch.where(none, -big, rng[1:]),
                         torch.where(none, -big, -rng[:1])])
        dist.all_reduce(ext, op=dist.ReduceOp.MAX)
        rmax, rmin = ext[:1], -ext[1:]
        span = torch.clamp_min(rmax - rmin, 1e-12)
        edges = rmin + span * self.grid
        # the histogram kernel takes a +inf last edge: ratios above the
        # reference's last edge clip into the last bucket either way
        hedges = torch.cat([edges[:-1], self.inf]).to(torch.float64)
        hist = bfrt_histogram(ratio.to(torch.float64),
                              cost.to(torch.float64), hedges)[0]
        dist.all_reduce(hist)
        csum = torch.cumsum(hist.to(dt), 0)
        crossed = csum >= budget - 1e-12
        bidx = _first_true(crossed)
        has_cross = crossed.any().reshape(1)
        prev = torch.clamp_min(bidx - 1, 0)
        lo_edge = torch.where(bidx == 0, -float("inf"), edges[prev])
        hi_edge = edges[bidx]
        base = torch.where(bidx == 0, 0.0, csum[prev])

        # ---- pass 2: this rank's K smallest in-bucket breakpoints, in
        # (ratio, index) order as the reference's top_k gives them.  One
        # stable sort of the masked ratios: the in-bucket ones are the
        # run of cnt_in keys after the last one <= lo_edge ----
        sr, sidx = torch.sort(torch.where(finite, ratio, big), stable=True)
        in_b = finite & (ratio > lo_edge) & (ratio <= hi_edge)
        cnt_in = in_b.sum()
        pos = (torch.searchsorted(sr, lo_edge, right=True) + self.ik
               ).clamp_max(n_loc - 1)
        valid = (self.ik < cnt_in) & (sr[pos] < big)
        idx = sidx[pos]
        r_k = torch.where(valid, sr[pos], big)
        blk = torch.cat([
            r_k, torch.where(valid, cost[idx], 0.0), d_loc[idx],
            (state_loc[idx] == 1).to(dt), valid.to(dt)]).to(torch.float64)
        blk = torch.cat([blk, (sh.rank * n_loc + idx).to(torch.float64),
                         (cnt_in > k).to(torch.float64).reshape(1),
                         r_k[-1:].to(torch.float64)])
        gat = torch.empty(sh.p * blk.numel(), dtype=torch.float64,
                          device=dev)
        _all_gather(gat, blk)
        gat = gat.view(sh.p, -1)
        r_g, cost_g, d_g, up_g, valid_g, g_g = (
            gat[:, f * k:(f + 1) * k].reshape(-1) for f in range(_FIELDS))
        trunc_g, kth_g = gat[:, -2], gat[:, -1].to(dt)
        r_g, valid_g = r_g.to(dt), valid_g > 0

        # ---- the replicated exact merge ----
        order = torch.sort(torch.where(valid_g, r_g, big), stable=True)[1]
        r_s, valid_s = r_g[order], valid_g[order]
        csum_in = base + torch.cumsum(
            torch.where(valid_s, cost_g[order].to(dt), 0.0), 0)
        crossed_in = (csum_in >= budget - 1e-12) & valid_s
        at = _first_true(crossed_in)
        r_exact = r_s[at]
        # exact iff the walk crossed within the gathered prefix and no
        # truncated rank could hide a breakpoint below the entering ratio
        ok = (crossed_in.any() & ((trunc_g == 0) | (r_exact <= kth_g)).all()
              ).reshape(1)
        sel = torch.where(ok, at, 0)               # fallback: bucket min
        pick = order[sel]
        q = g_g[pick].to(torch.int64)
        r_best = r_s[sel]

        # ---- flips: every ratio strictly below the entering one, plus
        # the gathered ties the walk consumed before the crossing ----
        flip_strict = finite & (ratio < r_best)
        merged = torch.empty_like(order)
        merged[order] = self.im
        mine = merged[sh.rank * k:(sh.rank + 1) * k]
        tie_sel = valid & (mine < sel) & (r_k >= r_best)
        flips = flip_strict.to(torch.int32).index_add_(
            0, idx, tie_sel.to(torch.int32)) > 0
        # flip absorption fvec = A dx: the masked mat-vec.  The reference
        # gathers the flipped columns when a shard has at most K strict
        # flips; choosing would need that count on the host (a sync), so
        # the port always reads A_loc once more, as the single-device
        # twin (core.lp_kernel) does
        dx = torch.where(flips, torch.where(state_loc == 1, -self.width,
                                            self.width), 0.0)
        lo_col = sh.rank * n_loc
        owner = (q >= lo_col) & (q < lo_col + n_loc)
        j_loc = (q - lo_col).clamp(0, n_loc - 1)
        acol = torch.where(owner, A[:, j_loc].squeeze(1), 0.0)
        tail = torch.cat([A @ dx, acol, flips.sum().to(dt).reshape(1)]
                         ).to(torch.float64)
        dist.all_reduce(tail)
        m = st.m
        rep = torch.cat([r_best.to(torch.float64), q.to(torch.float64),
                         d_g[pick], up_g[pick], tail[2 * m:],
                         has_cross.to(torch.float64), ok.to(torch.float64),
                         tail[m:2 * m], tail[:m]])
        return alpha, flips, rep


class UpdateStep:
    """The post-pivot maintenance step (the reference's
    ``make_update_step``): ``d -= theta alpha`` plus the bound-flip and
    basis-exchange bookkeeping on the state codes; shard-local, no
    collective.  ``theta``, ``q``, ``leave`` and ``leave_up`` are host
    values; returns new ``(d, state)``."""

    def __init__(self, shards: ColumnShards):
        self.shards = shards

    def __call__(self, d_loc, state_loc, alpha_loc, flip_loc, theta, q,
                 leave, leave_up):
        n_loc = d_loc.shape[0]
        lo_col = self.shards.rank * n_loc
        theta = float(theta)
        d = d_loc - theta * alpha_loc
        st = torch.where(flip_loc, 1 - state_loc, state_loc)
        for col, dv, sv in ((int(q), 0.0, 2),
                            (int(leave), -theta, int(bool(leave_up)))):
            j = col - lo_col
            if 0 <= j < n_loc:
                d[j] = dv
                st[j] = sv
        return d, st.to(state_loc.dtype)


class RefreshStep:
    """The refactorization support step (the reference's
    ``make_refresh_step``): ``d = c - y A`` on this rank's columns (zero
    on the basis) and the SUM over ranks of ``A xN``, for the host's
    ``xB = -Binv (A xN)``."""

    def __init__(self, shards: ColumnShards):
        self.shards = shards

    def __call__(self, A_loc, cf_loc, state_loc, l_loc, u_loc, y):
        y = torch.as_tensor(y, dtype=A_loc.dtype, device=A_loc.device)
        d = torch.where(state_loc == 2, 0.0, cf_loc - y @ A_loc)
        xN = torch.where(state_loc == 1, u_loc,
                         torch.where(state_loc == 0, l_loc, 0.0))
        xN = torch.where(torch.isfinite(xN), xN, 0.0)
        axn = A_loc @ xN
        dist.all_reduce(axn)
        return d, axn


def _vector_shard(shards: ColumnShards, n: int) -> slice:
    n_loc = n // shards.p
    return slice(shards.rank * n_loc, (shards.rank + 1) * n_loc)


def make_pq_step(mesh, m: int, n: int, num_buckets: int = NUM_BUCKETS,
                 gather_k: int = GATHER_K):
    """The distributed pricing + BFRT-selection step over ``mesh``.

    Returns ``(step, col_shard, vec_shard)``, as the reference returns
    ``(fn, col_spec, vec_spec)``: ``A[col_shard]`` and ``v[vec_shard]``
    are this rank's shards of an (m, n) matrix and an (n,) vector.
    ``step(A, d, l, u, state, rho, s, budget)`` takes this rank's shards
    of A ``(m, n/p)``, ``d``/``l``/``u`` and ``state`` (int32: 0 =
    at-lower, 1 = at-upper, 2 = basic) on its device, and the replicated
    ``rho`` (the pivot row of Binv), ``s`` (the sign of the primal
    infeasibility) and ``budget`` (|delta|); it returns ``(alpha,
    flip_mask, r_best, q, d_q, at_up_q, Acol, fvec, n_flips, has_cross,
    exact)`` as the reference does (alpha and the flip mask this rank's
    shard).  ``step.bind(A, l, u)`` gives the per-solve form the pivot
    loop uses."""
    shards = column_shards(mesh)
    step = PQStep(shards, m, n, num_buckets, gather_k)
    vec = _vector_shard(shards, n)
    return step, (slice(None), vec), vec


def make_update_step(mesh) -> UpdateStep:
    return UpdateStep(column_shards(mesh))


def make_refresh_step(mesh) -> RefreshStep:
    return RefreshStep(column_shards(mesh))


# ------------------------------------------------------ distributed solver


STEP_CACHE_MAXSIZE = 64   # distinct shape classes kept


class BoundedStepCache:
    """LRU cache of per-shape-class objects (the reference's jitted step
    triples and compiled batched cores; here the distributed step triples
    and the batched LP engine's launch workspaces).

    Replaces a bare ``functools.lru_cache``: same bound, but with
    explicit hit/miss/eviction counters (per-class churn is a real
    cost — an eviction storm means shapes are cycling faster than the
    cache can hold and should be visible, not silent).

    Thread-safe: entries and counters are guarded by ``_lock``, and each
    resolved ``get_or_create`` is exactly one hit or one miss, so
    ``hits + misses == lookups`` always holds.  A cold key is built by
    exactly one thread — the first caller claims the key with an
    in-flight event and runs ``factory()`` *outside* the lock (a build
    may be slow -- the reference traces a jit there, the port allocates
    device buffers; holding the lock would serialize every other shape
    class behind it), while later callers wait on the event and
    re-probe.
    """

    __guarded_by__ = {"_entries": "_lock", "hits": "_lock",
                      "misses": "_lock", "evictions": "_lock",
                      "lookups": "_lock", "_building": "_lock"}

    def __init__(self, maxsize: int = STEP_CACHE_MAXSIZE):
        self.maxsize = int(maxsize)
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.lookups = 0
        self._lock = threading.Lock()
        self._building: Dict[tuple, threading.Event] = {}

    # The probe and the insert live in different lock scopes by design:
    # the in-flight event in ``_building`` is the claim token that makes
    # the check-then-act atomic (waiters re-probe after the owner
    # publishes), so the REPRO009 shape here is the sanctioned pattern.
    # repro: allow[REPRO009] claim-token get-or-create: _building event
    # serializes builders; waiters re-probe after the owner's insert
    def get_or_create(self, key: tuple, factory):
        while True:
            racecheck.checkpoint("step_cache.probe")
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    self.lookups += 1
                    return entry
                ev = self._building.get(key)
                if ev is None:
                    # We own the build for this key.
                    ev = self._building[key] = threading.Event()
                    self.misses += 1
                    self.lookups += 1
                    break
            # Another thread is building this key: wait, then re-probe.
            # Unresolved probes are not charged, so each resolved call is
            # exactly one lookup and one of hit/miss.
            racecheck.wait_event(ev, "step_cache.wait")
        try:
            entry = factory()
        # repro: allow[REPRO004] claim-release path: the failure is
        # RE-RAISED after waking waiters (nothing is swallowed) — not
        # releasing the claim would park every waiter forever
        except BaseException:
            with self._lock:
                self._building.pop(key, None)
            ev.set()
            raise
        racecheck.checkpoint("step_cache.publish")
        with self._lock:
            self._entries[key] = entry
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                self.evictions += 1
            self._building.pop(key, None)
        ev.set()
        return entry

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        """Atomic snapshot — never torn: hits+misses == lookups."""
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "lookups": self.lookups,
                    "size": len(self._entries), "maxsize": self.maxsize}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


_STEP_CACHE = BoundedStepCache()


def step_cache_stats() -> dict:
    """Counters of the module step-triple cache (observability API)."""
    return _STEP_CACHE.stats()


def _cached_steps(mesh, m: int, npad: int, num_buckets: int, gather_k: int):
    """One (pq, update, refresh) triple per (mesh, shape), one lookup a
    solve, as the reference caches its jitted triples."""
    def build():
        shards = column_shards(mesh)
        return (PQStep(shards, m, npad, num_buckets, gather_k),
                UpdateStep(shards), RefreshStep(shards))
    return _STEP_CACHE.get_or_create((mesh, m, npad, num_buckets, gather_k),
                                     build)


def _any_rank(flag: bool, shards: ColumnShards) -> bool:
    """``flag`` of any rank (a MAX over the ranks; the flag itself where
    there is one rank): a host decision that may differ between ranks,
    such as a wall-clock deadline, made the same on all of them."""
    if shards.p == 1:
        return flag
    t = torch.tensor([float(flag)], dtype=torch.float64, device=shards.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.cpu()[0] > 0)


def _gather_state(state_loc, shards: ColumnShards) -> np.ndarray:
    """The whole state vector on every rank (host int32)."""
    out = torch.empty(shards.p * state_loc.shape[0], dtype=state_loc.dtype,
                      device=state_loc.device)
    _all_gather(out, state_loc)
    return out.cpu().numpy()


def solve_lp_dist(c, A_t, bl, bu, ub, *, mesh, lb=None,
                  max_iters: int = 5000, tol: float = 1e-7,
                  warm_start=None, refactor_every: int = None,
                  num_buckets: int = NUM_BUCKETS,
                  gather_k: int = GATHER_K,
                  budget=None, monitor=None, device="cuda"):
    """Revised dual simplex with DISTRIBUTED pricing (the ``mesh=`` path
    of ``core.lp.solve_lp``).

    Same conventions and pivot rules as ``solve_lp_np``, including the
    warm-start and budget/monitor contracts.  Every rank of ``mesh``
    calls it with the same arguments and gets the same ``LPResult``
    (see the module docstring); ``device`` must agree with the mesh
    (``"cpu"`` for a gloo mesh).  Per pivot: one ``pq_step``, one
    ``update_step`` and one device-to-host read (with a budget on more
    than one rank, one more: the ranks agree on its deadline).

    Resilience: any exception out of the pivot loop (the ``dist.shard``
    fault site included) or a degenerate stall past ``stall_bland`` falls
    back to ``solve_lp_np``, warm-started from the basis at the point of
    failure, with the same budget: ``single_host_fallback`` in
    ``LPResult.notes``.  The fault schedule is per process: armed alike
    on every rank, it fires on every rank at the same pivot.
    """
    from repro_torch.core.guard import THETA_EPS, NumericalMonitor
    from repro_torch.core.lp import (BUDGET, INFEASIBLE, ITER_LIMIT, OPTIMAL,
                                     LPResult, REFACTOR_EVERY, _prep,
                                     solve_lp_np)
    from repro_torch.runtime import faults
    dev = mesh_device(mesh, device)
    if refactor_every is None:
        refactor_every = REFACTOR_EVERY
    arrs, scale, m, n, start = _prep(c, A_t, bl, bu, ub, lb, warm_start,
                                     tol)
    N = n + m
    if arrs is None:
        res = LPResult(INFEASIBLE, np.zeros(n), 0.0, 0,
                       np.arange(n, N), np.zeros(N, bool), np.zeros(m))
        res.pivot_stats = {"exact": 0, "conservative": 0}
        return res
    cf, A, l, u = arrs
    basis0, at_upper0, winit, wnote = start
    notes = [] if wnote is None else [wnote]
    mon = monitor if monitor is not None else NumericalMonitor()
    if budget is not None:
        budget.start()
    shards = column_shards(mesh)
    p = shards.p
    Npad = -(-N // p) * p
    sl = _vector_shard(shards, Npad)

    def shard(v, fill=0.0, dtype=torch.float64):
        """This rank's columns of a host (..., N) array, padded past N
        with ``fill`` (copied on the host only where it must be)."""
        part = v[..., sl.start:min(sl.stop, N)]
        pad = sl.stop - sl.start - part.shape[-1]
        if pad:
            part = np.concatenate(
                [part, np.full(v.shape[:-1] + (pad,), fill, v.dtype)], -1)
        return torch.as_tensor(np.ascontiguousarray(part), dtype=dtype,
                               device=dev)

    basis = np.asarray(basis0, np.int64).copy()
    state0 = np.where(at_upper0, 1, 0).astype(np.int32)
    state0[basis] = 2                     # padding columns: basic, unpriced
    A_dev, cf_dev, l_dev, u_dev = shard(A), shard(cf), shard(l), shard(u)
    state_dev = shard(state0, 2, torch.int32)

    pq_step, update_step, refresh_step = _cached_steps(
        mesh, m, Npad, num_buckets, gather_k)
    price = pq_step.bind(A_dev, l_dev, u_dev)

    if winit is not None:
        # reuse the factors computed during warm-basis validation (twin
        # parity with solve_lp_np): no refactorization, no d recompute
        _, _, _, Binv, y, d0 = winit
        Binv = Binv.copy()
        y = y.copy()
        d_dev = shard(d0)
        xN = np.where(state0 == 1, u, np.where(state0 == 0, l, 0.0))
        xB = -Binv @ (A @ xN)
        since = 0
    else:
        d_dev = cf_dev                  # overwritten by refresh
        Binv = np.eye(m)
        xB = np.zeros(m)
        y = np.zeros(m)
        since = refactor_every          # force a factorization on entry

    def refresh():
        nonlocal Binv, xB, y, d_dev, since
        Binv = np.linalg.inv(A[:, basis])
        y = Binv.T @ cf[basis]
        d_dev, axn = refresh_step(A_dev, cf_dev, state_dev, l_dev, u_dev, y)
        xB = -Binv @ axn.cpu().numpy()
        since = 0

    status = ITER_LIMIT
    iters = 0
    stall = 0
    n_exact = n_cons = 0
    fallback_reason = None
    try:
        for iters in range(1, max_iters + 1):
            if budget is not None and _any_rank(
                    budget.out_of_time()
                    or iters > budget.remaining_pivots(), shards):
                status = BUDGET
                notes.append(f"budget: truncated at pivot {iters - 1}")
                break
            if since >= refactor_every:
                refresh()
            lB, uB = l[basis], u[basis]
            viol_lo = lB - xB
            viol_hi = xB - uB
            viol = np.maximum(viol_lo, viol_hi)
            r = int(np.argmax(viol))
            if viol[r] <= tol and since > 0:
                refresh()
                viol_lo = lB - xB
                viol_hi = xB - uB
                viol = np.maximum(viol_lo, viol_hi)
                r = int(np.argmax(viol))
            if viol[r] <= tol:
                status = OPTIMAL
                break
            above = bool(viol_hi[r] >= viol_lo[r])
            delta = xB[r] - (uB[r] if above else lB[r])
            s = 1.0 if delta > 0 else -1.0

            faults.maybe_raise(faults.SHARD, RuntimeError)
            alpha_dev, flip_dev, rep = price(d_dev, state_dev, Binv[r], s,
                                             abs(delta))
            # the pivot's one device->host read: everything the host loop
            # consumes (alpha and the flip mask stay on the device)
            rep = rep.cpu().numpy()
            if not rep[HAS_CROSS]:
                if since > 0:   # could be drift: retry on fresh factors
                    refresh()
                    continue
                status = INFEASIBLE
                break
            q = int(rep[Q])
            w = Binv @ rep[ACOL:ACOL + m]
            if abs(w[r]) < 1e-11:
                if since > 0:
                    refresh()
                    continue
                break           # cannot happen on fresh factors
            n_exact += int(rep[EXACT] > 0)
            n_cons += int(not rep[EXACT] > 0)
            leave = int(basis[r])
            # flip absorption: xB -= Binv @ (A[:, flips] @ dx)
            xB = xB - Binv @ rep[ACOL + m:]
            target = uB[r] if above else lB[r]
            t = (xB[r] - target) / w[r]
            xq = u[q] if rep[AT_UP_Q] > 0 else l[q]
            xB = xB - t * w
            xB[r] = xq + t
            theta = float(rep[D_Q]) / w[r]
            y = y + theta * Binv[r]
            Binv_r = Binv[r] / w[r]
            Binv = Binv - np.outer(w, Binv_r)
            Binv[r] = Binv_r
            basis[r] = q
            d_dev, state_dev = update_step(d_dev, state_dev, alpha_dev,
                                           flip_dev, theta, q, leave, above)
            since += 1
            # anti-cycling: degenerate streaks force a refactorize; past
            # stall_bland, fall back to the host twin (which has the
            # Bland's-rule mode; selection here is the BFRT step's)
            if abs(theta) <= THETA_EPS:
                stall += 1
                if stall == mon.stall_refactor:
                    mon.stall_refactors += 1
                    mon.stall_events += 1
                    since = refactor_every
                if stall >= mon.stall_bland:
                    mon.stall_events += 1
                    fallback_reason = (f"{stall} degenerate pivots "
                                       "(Bland mode is host-side)")
                    break
            else:
                stall = 0
    # repro: allow[REPRO004] guard contract: any shard/collective failure
    # (incl. the dist.shard fault site) falls back to the single-host twin
    except Exception as e:          # dead shard / collective failure
        fallback_reason = f"{type(e).__name__}: {e}"

    if budget is not None:
        budget.charge_pivots(iters)

    state_np = _gather_state(state_dev, shards)[:N]
    if fallback_reason is not None:
        # single-host fallback, warm-started from the failure-point basis
        notes.append(f"single_host_fallback: {fallback_reason}")
        res = solve_lp_np(c, A_t, bl, bu, ub, lb=lb, max_iters=max_iters,
                          tol=tol, warm_start=(basis.copy(),
                                               state_np == 1),
                          budget=budget, monitor=monitor)
        res.notes = tuple(notes) + res.notes
        res.pivot_stats = {"exact": n_exact, "conservative": n_cons,
                           "fallback": 1}
        return res

    # final answer always from a fresh factorization (twin parity)
    at_upper = state_np == 1
    in_basis = np.zeros(N, bool)
    in_basis[basis] = True
    at_upper[in_basis] = False
    Binv = np.linalg.inv(A[:, basis])
    xN = np.where(in_basis, 0.0, np.where(at_upper, u, l))
    xN[basis] = 0.0
    xB = -Binv @ (A @ xN)
    x = xN.copy()
    x[basis] = xB
    y = Binv.T @ cf[basis]
    obj_min = float(cf @ np.where(np.isfinite(x), x, 0.0))
    res = LPResult(status, x[:n], obj_min, iters, basis.copy(),
                   at_upper.copy(), y * scale, notes=tuple(notes))
    res.pivot_stats = {"exact": n_exact, "conservative": n_cons}
    return res


def pq_input_specs(m: int, n: int, dtype=torch.float64):
    """Abstract inputs of the pq_step (shape and dtype, no storage):
    ``(A, d, l, u, state, rho, s, budget)`` as ``meta`` tensors."""
    def f(shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")
    return (f((m, n)), f((n,)), f((n,)), f((n,)), f((n,), torch.int32),
            f((m,)), f(()), f(()))
