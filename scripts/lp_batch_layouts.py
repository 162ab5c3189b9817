#!/usr/bin/env python3
"""The batched LP kernel's two paths and the warp path's layouts, timed on
the main path's flights.

    python3 scripts/lp_batch_layouts.py [--no-full]

Needs one CUDA card and ``nvcc``.  ``csrc/lp_batch.cu`` runs a flight of
m_pad <= 32 and N <= ``WARP_N_MAX`` one warp a lane, up to
``WARP_LANES_MAX`` lanes a CTA, with ``(cf, A)`` staged in shared memory
when it fits (``STAGE_CF_A``), and every other flight one CTA a lane.
This builds the source and compile-time variants of it (nvcc ``-D``, all
at once): every flight on the CTA path (``WARP_N_MAX`` 0), the warp path
up to 1,024 columns (``WARP_N_MAX`` 1024, the source's own bound: a
second build of it, so the spread between two builds), the warp path
reading ``(cf,
A)`` from global memory (``STAGE_CF_A`` 0), the warp path at 8, 2
and 1 lanes a CTA, and the warp path's general forms of two specialised
steps: the Gauss-Jordan inverse in shared memory at every m_pad
(``WARP_INVERT_REGS`` 0; the source keeps it in registers up to 16
rows) and every run sorted by insertion (``WARP_SORT_NET`` 0; the
source sorts runs of up to 8 keys by a network in registers).  On the main path's flights
(``chip_smoke.lp_main_flights``: every flight of B&B at W = 64 on the
reference benchmark's instance, their sum and the largest alone; the
Dual Reducer's rung flight; the parity cell's flights (200k rows, B&B
at W = 8); unless ``--no-full``, four rungs of the full cell's h=3 Dual
Reducer LP, which needs the 10M-row build) it checks the
out packs -- bit-equal to the source's where a variant takes the
source's path (the same arithmetic), else within ``lane_mismatches``'
bar (the CTA path's sums add over 256 threads, the warp path's over
32) -- and times every build in
turns: the mean ms of ``reps`` rounds that launch every flight once
(CUDA events: launch gaps on the host included), in two rounds in
opposite order, and the kernels' device ms over one LaneSolver call a
flight under the profiler.
"""
import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np                                          # noqa: E402
import torch                                                # noqa: E402

import chip_smoke as cs                                     # noqa: E402
from repro_torch.kernels import _build, lp_batch            # noqa: E402

VARIANTS = {"source": None,
            "cta path only (WARP_N_MAX 0)": ("-DWARP_N_MAX=0",),
            "warp path to N = 1,024 (WARP_N_MAX 1024)":
                ("-DWARP_N_MAX=1024",),
            "warp, (cf, A) from global (STAGE_CF_A 0)": ("-DSTAGE_CF_A=0",),
            "warp, 8 lanes a CTA": ("-DWARP_LANES_MAX=8",),
            "warp, 2 lanes a CTA": ("-DWARP_LANES_MAX=2",),
            "warp, 1 lane a CTA": ("-DWARP_LANES_MAX=1",),
            "warp, Gauss-Jordan in shared memory (WARP_INVERT_REGS 0)":
                ("-DWARP_INVERT_REGS=0",),
            "warp, runs sorted by insertion (WARP_SORT_NET 0)":
                ("-DWARP_SORT_NET=0",)}


def solver_on(lib, proto):
    """A LaneSolver of ``proto``'s class that launches ``lib``'s kernel."""
    sv = lp_batch.LaneSolver(proto.m_pad, proto.n_pad, proto.K_pad,
                             proto.max_iters, proto.refactor_every,
                             proto.device)
    sv._bind(lib)
    return sv


def launch_all(flights):
    return [sv._launch(cf, A, sv.max_iters) for sv, cf, A, _ in flights]


def kernel_ms(flights, reps: int) -> float:
    """Mean ms of ``reps`` rounds that launch every flight once."""
    for sv, cf, A, pack in flights:
        sv(cf, A, pack)                 # loads the in pack onto the card
    return cs.timed_ms(lambda: launch_all(flights), reps)


def device_ms(flights) -> float:
    """The kernels' device ms over one ``LaneSolver`` call a flight (the
    profiler's: no host gaps, each flight's in pack just copied to the
    card, as on the main path)."""
    return cs.per_call_device(lambda: [sv(cf, A, pack)
                                       for sv, cf, A, pack in flights],
                              1, lp_batch, "lp_batch")["device_ms"]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-full", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        jobs = {name: ex.submit(_build.load, "lp_batch", lp_batch._SIG)
                if d is None else
                ex.submit(_build.load_variant, "lp_batch", lp_batch._SIG, d)
                for name, d in VARIANTS.items()}
        libs = {name: job.result() for name, job in jobs.items()}
    print(cs.smi(), flush=True)
    flights = cs.lp_main_flights(torch.device("cuda"), full=not args.no_full)
    valid = lambda f: int(np.count_nonzero(               # noqa: E731
        f[3][:, 3 * f[0].N + 1 + f[0].m_pad]))
    bnb = flights.pop("bnb")
    big = max(bnb, key=valid)
    cases = {f"bnb W=64, all {len(bnb)} flights (N={big[0].N})": (bnb, 5),
             f"bnb largest flight ({valid(big)} lanes, N={big[0].N})":
                 ([big], 50)}
    cases.update({f"{k} ({valid(v[0])} lanes, N={v[0][0].N})": (v, 50)
                  for k, v in flights.items()})
    for case, (fl, reps) in cases.items():
        per = {name: [(solver_on(lib, f[0]), f[1], f[2], f[3]) for f in fl]
               for name, lib in libs.items()}
        plans = {}
        for name, svs in per.items():
            for (sv, cf, A_, pack), f in zip(svs, fl):
                got = sv(cf, A_, pack)
                if sv.plan["path"] == f[0].plan["path"]:
                    cs.check(np.array_equal(got, f[4], equal_nan=True),
                             f"{case}: {name} differs from the source's "
                             "kernel")
                else:
                    bad, _, _ = lp_batch.lane_mismatches(got, f[4], pack,
                                                         sv.m_pad)
                    cs.check(not bad, f"{case}: {name}: lanes {bad} differ "
                                      "from the source's kernel")
            plans[name] = sorted({json.dumps(sv.plan) for sv, *_ in svs})
        order = list(per.items())
        times = {name: [] for name in per}
        for rnd in range(2):
            for name, svs in order if rnd == 0 else order[::-1]:
                times[name].append(kernel_ms(svs, reps))
        for name, ms in times.items():
            print(json.dumps({"case": case, "variant": name, "reps": reps,
                              "plans": plans[name], "ms_rounds": ms,
                              "ms_mean": float(np.mean(ms)),
                              "device_ms": device_ms(per[name])}),
                  flush=True)


if __name__ == "__main__":
    main()
