#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports nothing of JAX or of the JAX
package.  Phases, one line each (or one per kernel):

1. build: every ``csrc/*.cu`` compiled by nvcc for sm_90a, in parallel;
2. kernels: each hand-written kernel against its plain torch version on
   the card at fixed shapes (time, plain time, bound and, where one
   exists, the nearest single PyTorch call);
3. parity: a 200k-row TPC-H table built and solved once on the card and
   once on the CPU -- identical layers and gids, equal objective;
4. full: the 10M-row TPC-H table (d_f=100, alpha=100k) partitioned on the
   card and Q2_TPCH solved at hardness 3 and 5 through the device LP, with
   every kernel's launch count read around that run, then a profiled
   second partition and solve;
5. main-path inputs: the main path of phase 4 run once more with a copy of
   the arguments of every kernel call kept, and each kernel held against
   its plain version on exactly those inputs; the times in the ``kernels``
   line are taken at the largest of them.

Then the card's name and power limit (nvidia-smi), one JSON line listing
every kernel, and a last line ``{"ok": true, "device": {...}}``.  Any
failed check exits non-zero before that line.  Without CUDA, or without the
package beside the script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and float64 outside
# the tensor cores (every kernel here is float64 vector code)
HBM_BYTES_PER_S = 3.35e12
F64_OPS_PER_S = 34e12

REL_TOL = 1e-12           # float64 sums vs the plain version, relative
ATTRS = ["price", "quantity", "discount", "tax"]
ILP_KW = dict(max_nodes=200, time_limit_s=600.0)   # B&B capped by nodes

SOURCES = {"pricing": ("src/repro_torch/csrc/pricing.cu",
                       "src/repro/kernels/pricing.py:51"),
           "bfrt_histogram": ("src/repro_torch/csrc/bfrt.cu",
                              "src/repro/kernels/bfrt.py:30"),
           "segment_stats": ("src/repro_torch/csrc/segstats.cu",
                             "src/repro/kernels/segstats.py:25"),
           "dlv_scan": ("src/repro_torch/csrc/dlv_scan.cu",
                        "src/repro/core/dlv.py:46")}
TOLERANCE = {"pricing": "1e-12 of max(1, |plain|); inf where plain is inf",
             "bfrt_histogram": "q, flip mask, has_cross exact vs the "
                               "sequential rule; counts exact; sums 1e-12 "
                               "of max(1, |plain|)",
             "segment_stats": "counts exact; sums 1e-12 of the group's sum "
                              "of |v|; sums of squares 1e-12 relative",
             "dlv_scan": "cuts bit-equal to dlv_scan_plain and to the "
                         "row-step scan"}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def say(phase: str, **kv) -> None:
    print(f"{phase}: " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F64_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _numbers(shape, nbytes, ops, ms, plain_ms, library_ms=None, **extra):
    b, by = bound_ms(nbytes, ops)
    return {"shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
            "bound_by": by, "library_ms": library_ms, **extra}


# ---------------------------------------- each kernel against its plain


def pricing_check(args, tol=REL_TOL) -> float:
    """Kernel vs plain pricing on ``args``: max abs error; fails beyond
    ``tol`` x max(1, |plain|) or on an inf that is not matched."""
    import torch
    from repro_torch.kernels.pricing import pricing, pricing_plain
    worst = 0.0
    for g, w in zip(pricing(*args), pricing_plain(*args)):
        both_inf = torch.isinf(g) & torch.isinf(w) & (g == w)
        diff = torch.where(both_inf, 0.0, (g - w).abs())
        check(bool(torch.isfinite(diff).all()), "pricing: inf mismatch")
        scale = torch.where(both_inf, 1.0, w.abs().clamp_min(1.0))
        check(bool((diff <= tol * scale).all()),
              f"pricing disagrees with its plain version "
              f"(max abs err {float(diff.max())})")
        worst = max(worst, float(diff.max()))
    return worst


def pricing_times(args) -> dict:
    from repro_torch.kernels.pricing import pricing, pricing_plain
    A, rho = args[0], args[1]
    m, N = A.shape
    nbytes = (m * N + m + 1) * 8 + N * (8 + 4 + 8 + 8) + 3 * N * 8
    return _numbers(f"m={m} N={N} f64", nbytes, 2 * m * N + 4 * N,
                    timed_ms(lambda: pricing(*args), 200),
                    timed_ms(lambda: pricing_plain(*args), 50),
                    timed_ms(lambda: rho @ A, 200))


def bfrt_check(ratio, cost, budget) -> float:
    """``bfrt_select`` (histogram kernel + device pass 2) against the exact
    sequential rule -- q, flip mask and has_cross equal -- and the
    histogram kernel against its plain version: counts exact, sums to
    REL_TOL relative, two runs bit-identical.  Returns the sums' max abs
    error."""
    import torch
    from repro_torch.kernels.bfrt import (bfrt_histogram,
                                          bfrt_histogram_plain, bfrt_select,
                                          bfrt_sequential, bucket_edges)
    want = bfrt_sequential(ratio.cpu().numpy(), cost.cpu().numpy(),
                           float(budget))
    q, flips, ok = bfrt_select(ratio, cost, budget)
    check(bool(ok) == want[2], "bfrt has_cross differs from the sequential "
                               "rule")
    if want[2]:
        check(int(q) == want[0], f"bfrt q {int(q)} != {want[0]}")
        check(np.array_equal(flips.cpu().numpy(), want[1]),
              "bfrt flip mask differs from the sequential rule")
    edges = bucket_edges(ratio)
    s_k, n_k = bfrt_histogram(ratio, cost, edges)
    s_p, n_p = bfrt_histogram_plain(ratio, cost, edges)
    check(torch.equal(n_k, n_p), "bfrt counts differ")
    err = float((s_k - s_p).abs().max())
    check(bool(((s_k - s_p).abs() <= REL_TOL * s_p.abs().clamp_min(1.0))
               .all()), f"bfrt sums differ (max abs err {err})")
    s2, _ = bfrt_histogram(ratio, cost, edges)
    check(torch.equal(s_k, s2), "bfrt histogram is not deterministic")
    return err


def bfrt_times(ratio, cost, budget) -> dict:
    from repro_torch.kernels.bfrt import (bfrt_histogram,
                                          bfrt_histogram_plain, bfrt_select,
                                          bucket_edges)
    edges = bucket_edges(ratio)
    N, NB = ratio.shape[0], edges.shape[0]
    return _numbers(
        f"N={N} NB={NB} f64", 16 * N + NB * 8 + 2 * NB * 8,
        N * (int(np.log2(NB)) + 2),
        timed_ms(lambda: bfrt_histogram(ratio, cost, edges), 200),
        timed_ms(lambda: bfrt_histogram_plain(ratio, cost, edges), 50),
        None, select_ms=timed_ms(lambda: bfrt_select(ratio, cost, budget),
                                 50))


def segstats_check(vals, ids, G) -> float:
    """Kernel vs plain segment stats: counts exact, sums to REL_TOL of the
    group's sum of |v|, sums of squares to REL_TOL relative, two runs
    bit-identical.  Returns the max abs error."""
    import torch
    from repro_torch.kernels.segstats import (segment_stats,
                                              segment_stats_plain)
    cnt, sm, sq = segment_stats(vals, ids, G)
    cnt_p, sm_p, sq_p = segment_stats_plain(vals, ids, G)
    check(torch.equal(cnt, cnt_p), "segment_stats counts differ")
    mass = torch.zeros((G, vals.shape[1]), dtype=torch.float64,
                       device=vals.device)
    mass.index_add_(0, ids, vals.abs())
    err = 0.0
    for got, want, scale in ((sm, sm_p, mass), (sq, sq_p, sq_p)):
        diff = (got - want).abs()
        err = max(err, float(diff.max()))
        check(bool((diff <= REL_TOL * scale.clamp_min(1e-300)).all()),
              f"segment_stats sums differ (max abs err {float(diff.max())})")
    again = segment_stats(vals, ids, G)
    check(all(torch.equal(x, y) for x, y in zip((cnt, sm, sq), again)),
          "segment_stats is not deterministic")
    return err


def segstats_times(vals, ids, G) -> dict:
    import torch
    from repro_torch.kernels.segstats import (segment_stats,
                                              segment_stats_plain)
    n, k = vals.shape
    acc = torch.zeros((G, k), dtype=torch.float64, device=vals.device)
    return _numbers(
        f"n={n} k={k} G={G} f64 sorted ids",
        n * k * 8 + n * 8 + G * (1 + 2 * k) * 8, 3 * n * k + n,
        timed_ms(lambda: segment_stats(vals, ids, G), 10),
        timed_ms(lambda: segment_stats_plain(vals, ids, G), 5),
        timed_ms(lambda: acc.index_add_(0, ids, vals), 10))


def row_step_check(vals, Ls, beta, cuts, max_rows: int = 2048,
                   max_elems: int = 1 << 24) -> int:
    """Hold the scan kernel's ``cuts`` against ``scan_cols_plain``, which
    does the kernel's compensated arithmetic step for step.

    A scan restarted at a cut is in the very state that the running scan
    is in just after that cut.  So every window from a segment start or a
    cut up to the next cut, scanned alone, must cut at its last row and
    nowhere before it; a window that runs to its segment's end must not cut
    at all.  Windows are scanned side by side as columns; one longer than
    ``max_rows`` is checked over its first ``max_rows`` rows.  Returns the
    number of windows checked."""
    import torch
    from repro_torch.kernels.dlv_scan import scan_cols_plain
    dev = vals.device
    Ls = np.asarray(Ls, np.int64)
    n = len(vals)
    seg_end = np.cumsum(Ls)
    cut_h = cuts.cpu().numpy()
    starts = np.union1d(seg_end[Ls > 0] - Ls[Ls > 0], np.flatnonzero(cut_h))
    nxt = np.append(starts[1:], n)
    seg = np.searchsorted(seg_end, starts, side="right")
    to_cut = (nxt < n) & cut_h[np.minimum(nxt, n - 1)]
    length = nxt - starts + to_cut
    long = length > max_rows
    length[long] = max_rows
    to_cut[long] = False
    bars = torch.as_tensor(np.asarray(beta, np.float64)[seg],
                           dtype=torch.float64, device=dev)
    order = np.argsort(length, kind="stable")
    i = 0
    while i < len(order):
        j = i + 1
        while j < len(order) and length[order[j]] * (j + 1 - i) <= max_elems:
            j += 1
        sub = order[i:j]
        i = j
        ln = torch.as_tensor(length[sub], dtype=torch.int64, device=dev)
        st = torch.as_tensor(starts[sub], dtype=torch.int64, device=dev)
        ridx = torch.arange(int(length[sub].max()), dtype=torch.int64,
                            device=dev)[:, None]
        V = vals[st[None, :] + torch.minimum(ridx, ln[None, :] - 1)]
        got = scan_cols_plain(V, bars[sub]) & (ridx < ln[None, :])
        want = torch.zeros_like(got)
        cols = torch.arange(len(sub), dtype=torch.int64, device=dev)
        want[ln - 1, cols] = torch.as_tensor(to_cut[sub], device=dev)
        check(torch.equal(got, want),
              f"dlv_scan cuts differ from the compensated row-step scan "
              f"(the kernel's own arithmetic) in "
              f"{int((got != want).any(0).sum())} windows: a kernel fault")
    return len(starts)


def dlv_check(vals, Ls, beta, **kw):
    """Scan kernel vs ``dlv_scan_plain`` (bit-equal cuts) and vs the
    row-step scan on every window between its cuts.  Returns (cuts, plain
    ms, windows checked)."""
    import torch
    from repro_torch.kernels.dlv_scan import dlv_scan, dlv_scan_plain
    got = dlv_scan(vals, Ls, beta, **kw)
    windows = row_step_check(vals, Ls, beta, got)
    t0 = time.perf_counter()
    want = dlv_scan_plain(vals, Ls, beta, **kw)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    check(torch.equal(got, want),
          f"dlv_scan cuts differ from dlv_scan_plain in "
          f"{int((got != want).sum())} rows, though they agree with the "
          f"row-step scan: rounding of the plain version's prefix sums")
    return got, plain, windows


def dlv_times(vals, Ls, beta, plain_ms, **kw) -> dict:
    from repro_torch.kernels.dlv_scan import dlv_scan
    total, nseg = len(vals), len(Ls)
    return _numbers(f"{nseg} segments, {total} rows",
                    total * 8 + nseg * 24 + total, 14 * total,
                    timed_ms(lambda: dlv_scan(vals, Ls, beta, **kw), 2),
                    plain_ms)


# --------------------------------------------------------------- phase 2


def kernel_pricing(dev, N: int = 100_004):
    import torch
    rng = np.random.default_rng(1)
    m = 4

    def args(dt):
        t = functools.partial(torch.as_tensor, device=dev)
        return (t(rng.normal(size=(m, N)), dtype=dt),
                t(rng.normal(size=m), dtype=dt),
                t(np.abs(rng.normal(size=N)), dtype=dt),
                t(rng.integers(0, 3, N), dtype=torch.int32),
                t(np.zeros(N), dtype=dt), t(rng.uniform(1, 3, N), dtype=dt),
                t(-1.0, dtype=dt))

    err32 = pricing_check(args(torch.float32), 1e-5)
    a = args(torch.float64)
    err = pricing_check(a)
    out = pricing_times(a)
    say("kernel pricing", max_abs_err=err, f32_max_abs_err=err32, **out,
        library="rho@A (alpha only: no eligibility, ratio or cost)")
    return err, out


def kernel_bfrt(dev, N: int = 100_004):
    import torch
    rng = np.random.default_rng(2)
    r = np.where(rng.random(N) < 0.3, rng.uniform(0, 10, N), np.inf)
    c = np.where(np.isfinite(r), rng.uniform(0.1, 2, N), 0.0)
    ratio = torch.as_tensor(r, dtype=torch.float64, device=dev)
    cost = torch.as_tensor(c, dtype=torch.float64, device=dev)
    err = max(bfrt_check(ratio, cost, budget)
              for budget in (0.5, 100.0, 0.3 * c.sum(), 2 * c.sum()))
    out = bfrt_times(ratio, cost, 100.0)
    say("kernel bfrt_histogram", max_abs_err=err, q_and_flips="exact", **out)
    return err, out


def kernel_segstats(dev, n: int = 10_000_000):
    """Two sortings of 10M x 4 rows: G=100k groups of ~100 rows, and round
    1 of the 10M build's shape -- 81 groups of ~123k rows, so that every
    run crosses ~960 of the kernel's 128-row chunks."""
    import torch
    rng = np.random.default_rng(3)
    k = 4
    vals = torch.as_tensor(rng.normal(size=(n, k)), dtype=torch.float64,
                           device=dev)
    worst, out = 0.0, {}
    for G in (100_000, 81):
        ids = torch.as_tensor(np.sort(rng.integers(0, G, n)), device=dev)
        err = segstats_check(vals, ids, G)
        worst = max(worst, err)
        out[G] = segstats_times(vals, ids, G)
        say("kernel segment_stats", max_abs_err=err, **out[G],
            library="index_add_ (sums only: no count, sumsq)")
    return worst, dict(out[100_000], round1_shape=out[81])


def _segments(rng, lens):
    """Sorted, mean-centred segments back to back, and their betas."""
    total = int(lens.sum())
    seg = np.repeat(np.arange(len(lens)), lens)
    v = rng.normal(size=total) * rng.uniform(0.5, 2.0, len(lens))[seg] \
        + rng.uniform(-1e3, 1e3, len(lens))[seg]
    v = v[np.lexsort((v, seg))]
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    sums = np.add.reduceat(v, starts)
    v = v - (sums / lens)[seg]
    var = np.add.reduceat(v * v, starts) / lens
    return v, 13.5 * var / 100 ** 2


def kernel_dlv_scan(dev, long: int = 10_000_000, nseg: int = 10_000):
    import torch
    rng = np.random.default_rng(4)
    out = {}
    for label, lens in (("1x10M", np.array([long])),
                        ("10kx1000", rng.integers(500, 1501, nseg))):
        v, beta = _segments(rng, lens)
        vals = torch.as_tensor(v, dtype=torch.float64, device=dev)
        got, plain, windows = dlv_check(vals, lens, beta, pitch=100)
        out[label] = dlv_times(vals, lens, beta, plain, pitch=100)
        say(f"kernel dlv_scan[{label}]", cuts=int(got.sum()),
            max_abs_err=0.0, cuts_bit_equal=True,
            row_step_windows=windows, **out[label])
    return 0.0, dict(out["1x10M"], multi_segment=out["10kx1000"])


# ------------------------------------------------------------ phases 3, 4


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def solve(eng, query, budget=None):
    """``eng.solve`` with the layer LPs on the engine's device (the port's
    ``solve_lp_kernel``); returns (result, seconds)."""
    from repro_torch.core.lp_kernel import solve_lp_kernel
    t0 = time.perf_counter()
    res = eng.solve(query, ilp_kwargs=ILP_KW, budget=budget,
                    lp_solver=solve_lp_kernel)
    _sync(eng.device)
    return res, time.perf_counter() - t0


def build_and_solve(table, query, *, d_f, alpha, device):
    from repro_torch.core.engine import PackageQueryEngine
    eng = PackageQueryEngine(table, ATTRS, d_f=d_f, alpha=alpha, seed=0,
                             device=device)
    t0 = time.perf_counter()
    eng.partition()
    _sync(device)
    part_s = time.perf_counter() - t0
    res, solve_s = solve(eng, query)
    return eng, res, part_s, solve_s


def phase_parity(rows: int = 200_000, alpha: int = 2000,
                 devices=("cuda", "cpu")) -> None:
    from repro_torch.core.hardness import Q2_TPCH, column_stats, instantiate
    from repro_torch.data.synth_tables import make_table
    table = make_table("tpch", rows, seed=0)
    q = instantiate(Q2_TPCH, column_stats(table, ATTRS), 3)
    (eg, rg, pg, sg), (ec, rc, pc, sc) = (
        build_and_solve(table, q, d_f=100, alpha=alpha, device=dev)
        for dev in devices)
    sizes = [ly.size for ly in eg.hierarchy.layers]
    check(sizes == [ly.size for ly in ec.hierarchy.layers],
          "parity: layer sizes differ between cuda and cpu")
    for lg, lc in zip(eg.hierarchy.layers[1:], ec.hierarchy.layers[1:]):
        check(np.array_equal(lg.part.gid, lc.part.gid),
              "parity: gids differ between cuda and cpu")
        check(np.array_equal(lg.part.order, lc.part.order),
              "parity: order differs between cuda and cpu")
    check(rg.feasible and rc.feasible, "parity: h=3 solve infeasible")
    check(q.check_package(table, rg.idx, rg.mult),
          "parity: cuda package fails check_package")
    rel = abs(rg.obj - rc.obj) / max(1.0, abs(rc.obj))
    check(rel <= 1e-6, f"parity: objective {rg.obj} vs {rc.obj}")
    say("parity", rows=rows, layers=sizes, gids="identical",
        obj_cuda=rg.obj, obj_cpu=rc.obj, rel_diff=rel,
        partition_s_cuda=pg, partition_s_cpu=pc, solve_s_cuda=sg,
        solve_s_cpu=sc)


def main_path(table, q3, q5, alpha, device):
    """The main path: partition, then Q2_TPCH at h=3 and h=5 through the
    device LP.  Returns (engine, r3, partition s, h=3 s, r5, h=5 s)."""
    from repro_torch.core import guard
    eng, r3, part_s, s3 = build_and_solve(table, q3, d_f=100, alpha=alpha,
                                          device=device)
    r5, s5 = solve(eng, q5, budget=guard.SolveBudget(deadline_s=300.0))
    return eng, r3, part_s, s3, r5, s5


def phase_full(rows: int = 10_000_000, alpha: int = 100_000,
               device="cuda"):
    from repro_torch import kernels
    from repro_torch.core import guard
    from repro_torch.core.hardness import Q2_TPCH, column_stats, instantiate
    from repro_torch.data.synth_tables import make_table
    t0 = time.perf_counter()
    table = make_table("tpch", rows, seed=0)
    stats = column_stats(table, ATTRS)
    q3, q5 = instantiate(Q2_TPCH, stats, 3), instantiate(Q2_TPCH, stats, 5)
    gen_s = time.perf_counter() - t0
    defined = {guard.OK, guard.DEGRADED, guard.INFEASIBLE,
               guard.BUDGET_EXHAUSTED}

    kernels.reset_launches()
    eng, r3, part_s, s3, r5, s5 = main_path(table, q3, q5, alpha, device)
    counts = kernels.launch_counts()

    sizes = [ly.size for ly in eng.hierarchy.layers]
    ok3 = bool(r3.feasible and q3.check_package(table, r3.idx, r3.mult))
    for h, r, s in ((3, r3, s3), (5, r5, s5)):
        say(f"full h={h}", rows=rows, layers=sizes,
            table_gen_s=gen_s, partition_s=part_s, solve_s=s,
            feasible=r.feasible, obj=r.obj, lp_obj=r.lp_obj,
            package_size=int(r.mult.sum()) if r.feasible else 0,
            check_package=(q3 if h == 3 else q5).check_package(
                table, r.idx, r.mult) if r.feasible else None,
            report_status=r.report.status,
            lp_iters=getattr(r.ps_stats, "lp_iters", None),
            status=json.dumps(r.status))
    say("full launches", **counts)
    check(ok3, "full: h=3 solve is not a feasible, valid package")
    check(r3.report.status in (guard.OK, guard.DEGRADED),
          f"full: h=3 report status {r3.report.status}")
    check(r5.report.status in defined,
          f"full: h=5 report status {r5.report.status}")
    if r5.feasible:
        check(q5.check_package(table, r5.idx, r5.mult),
              "full: h=5 package fails check_package")
    for name, n in counts.items():
        check(n > 0, f"full: kernel {name} was never launched on the main "
                     "path")

    # where the time goes: device busy time of a second partition and a
    # second h=3 solve under torch.profiler, against the unprofiled walls
    from repro_torch.core.engine import PackageQueryEngine
    for label, wall, fn in (
            ("partition", part_s, lambda: PackageQueryEngine(
                table, ATTRS, d_f=100, alpha=alpha, seed=0,
                device=device).partition()),
            ("solve h=3", s3, lambda: solve(eng, q3))):
        busy_ms, reads, ours, top = device_profile(fn)
        say(f"profile {label}", wall_s=wall, device_busy_s=busy_ms / 1e3,
            idle_share=1.0 - busy_ms / 1e3 / wall, device_to_host=reads,
            kernels=json.dumps(ours), top=json.dumps(top))
    say("profile pivots", layer_lps=eng.hierarchy.L,
        layer_lp_pivots=r3.ps_stats.lp_iters)
    return counts, (table, q3, q5, alpha, device)


def device_profile(fn):
    """(device busy ms, device-to-host copies, device ms and calls of this
    repo's kernels, top device ops) of one call of ``fn``, from
    torch.profiler's CUDA activity (kernels, copies and fills)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows, reads, ours = [], 0, {}
    for ev in prof.key_averages():
        if ev.key.startswith("Memcpy DtoH"):
            reads += ev.count
        name = ev.key.split("(")[0].replace("void ", "")
        if name.startswith(("pricing_kernel", "bfrt_hist_", "segstats_",
                            "dlv_scan_kernel")):
            ms0, n0 = ours.get(name, (0.0, 0))
            ours[name] = (ms0 + getattr(ev, "self_device_time_total",
                                        0.0) / 1e3, n0 + ev.count)
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us / 1e3, ev.key, ev.count))
    rows.sort(reverse=True)
    top = [{"op": k[:60], "ms": ms, "calls": n} for ms, k, n in rows[:8]]
    return sum(r[0] for r in rows), reads, ours, top


# --------------------------------------------------------------- phase 5

# the names by which the main path's modules call each kernel's wrapper
CALL_SITES = {"pricing": ("repro_torch.core.lp_kernel", "pricing"),
              "bfrt_histogram": ("repro_torch.core.lp_kernel",
                                 "bfrt_select"),
              "segment_stats": ("repro_torch.core.dlv", "segment_stats"),
              "dlv_scan": ("repro_torch.core.dlv", "dlv_scan")}


def _copy(a):
    import torch
    if isinstance(a, torch.Tensor):
        return a.clone()
    return a.copy() if isinstance(a, np.ndarray) else a


@contextlib.contextmanager
def capturing():
    """Keep a copy of the arguments of every kernel call made inside the
    block: {kernel name: [(args, kwargs), ...]}."""
    calls = {name: [] for name in CALL_SITES}
    saved = []
    for name, (modname, attr) in CALL_SITES.items():
        mod = importlib.import_module(modname)
        fn = getattr(mod, attr)

        def kept(*args, _fn=fn, _log=calls[name], **kw):
            _log.append((tuple(_copy(a) for a in args),
                         {k: _copy(v) for k, v in kw.items()}))
            return _fn(*args, **kw)

        saved.append((mod, attr, fn))
        setattr(mod, attr, kept)
    try:
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def phase_main_inputs(counts, table, q3, q5, alpha, device):
    """Each kernel against its plain version on every input that the main
    path gives it; returns {kernel: (max abs err, numbers at its largest
    call)}."""
    import torch
    from repro_torch import kernels
    kernels.reset_launches()
    with capturing() as calls:
        main_path(table, q3, q5, alpha, device)
    again = kernels.launch_counts()
    say("main-path inputs", calls=json.dumps(
        {k: len(v) for k, v in calls.items()}),
        launches_as_in_phase_4=again == counts)
    for name, got in calls.items():
        check(len(got) > 0, f"main path: no call of {name} was kept")

    def compare(name, each, size):
        """``each`` on every kept call of ``name``: (results, the largest
        call's args and kwargs, its index)."""
        t0 = time.perf_counter()
        res = [each(*a, **kw) for a, kw in calls[name]]
        torch.cuda.synchronize()
        sizes = [size(*a) for a, _ in calls[name]]
        big = int(np.argmax(sizes))
        say(f"main-path {name}", calls=len(res), sizes=f"{min(sizes)}.."
            f"{max(sizes)} ({len(set(sizes))} distinct)",
            check_s=time.perf_counter() - t0)
        return res, calls[name][big], big

    out = {}
    res, (a, _), _ = compare("pricing", lambda *a: pricing_check(a),
                             lambda A, *_: A.shape[1])
    out["pricing"] = (max(res), pricing_times(a))
    res, (a, _), _ = compare("bfrt_histogram", bfrt_check,
                             lambda r, *_: r.shape[0])
    out["bfrt_histogram"] = (max(res), bfrt_times(*a))
    res, (a, _), _ = compare("segment_stats", segstats_check,
                             lambda v, *_: v.shape[0])
    out["segment_stats"] = (max(res), segstats_times(*a))
    res, (a, kw), big = compare("dlv_scan",
                                lambda *a, **kw: dlv_check(*a, **kw)[1:],
                                lambda v, *_: len(v))
    # the largest call's plain time was taken while checking it
    out["dlv_scan"] = (0.0, dlv_times(*a, res[big][0], **kw))
    windows = sum(r[1] for r in res)
    for name, (err, nums) in out.items():
        extra = {"row_step_windows": windows} if name == "dlv_scan" else {}
        say(f"main-path {name} at its largest call", max_abs_err=err,
            **extra, **nums)
    return out


# ------------------------------------------------------------------ main


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs a card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    t_all = time.perf_counter()

    build_s = _build.build_all()
    card = smi()
    say("build", seconds=build_s, sources=len(_build.SOURCES),
        card=json.dumps(card))
    print(card, flush=True)

    fixed = {}
    for name, fn in (("pricing", kernel_pricing),
                     ("bfrt_histogram", kernel_bfrt),
                     ("segment_stats", kernel_segstats),
                     ("dlv_scan", kernel_dlv_scan)):
        fixed[name] = fn(dev)
        torch.cuda.synchronize()

    phase_parity()
    torch.cuda.synchronize()
    counts, inputs = phase_full()
    torch.cuda.synchronize()
    main_nums = phase_main_inputs(counts, *inputs)
    torch.cuda.synchronize()

    entries = []
    for name, (source, replaces) in SOURCES.items():
        err_f, nums_f = fixed[name]
        err_m, nums_m = main_nums[name]
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": max(err_f, err_m),
                        "tolerance": TOLERANCE[name], **nums_m,
                        "fixed_shape": nums_f})
    say("done", seconds=time.perf_counter() - t_all)
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
