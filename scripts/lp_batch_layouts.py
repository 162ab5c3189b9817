#!/usr/bin/env python3
"""Where the batched LP kernel should keep a lane's per-column state.

    python3 scripts/lp_batch_layouts.py

Needs one CUDA card and ``nvcc``.  ``csrc/lp_batch.cu`` keeps a lane's
d, alpha, breakpoint keys, bound flags and bounds in shared memory when
its N columns fit (``NS_MAX``), else in a global workspace (read through
L1/L2).  This builds copies of the source into ``build/probe/`` with
``NS_MAX`` at the source's value and at 0 (every lane in the global
workspace), checks that both give the same out packs, bit for bit, and
times them in turns on the main path's flights: every flight of B&B at
W = 64 on the reference benchmark's instance (N = 164; their sum, and the
largest flight alone) and the Dual Reducer's rung flight (n = 300, R = 12,
warm; N = 308).  One line per flight and variant: the mean ms of ``reps``
back-to-back launches (CUDA events), in two rounds in opposite order.
"""
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np                                          # noqa: E402
import torch                                                # noqa: E402

import chip_smoke as cs                                     # noqa: E402
from repro_torch.kernels import _build, lp_batch            # noqa: E402


def build(ns_max: int) -> ctypes.CDLL:
    src = (ROOT / "src/repro_torch/csrc/lp_batch.cu").read_text()
    src, hits = re.subn(r"#define NS_MAX \d+", f"#define NS_MAX {ns_max}",
                        src)
    assert hits == 1
    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"lp_batch_ns{ns_max}.cu"
    so = out / f"liblp_batch_ns{ns_max}.so"
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.BASE_FLAGS,
                    *_build.EXTRA_FLAGS["lp_batch"], "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in lp_batch._SIG.items():
        getattr(lib, fn).argtypes = list(argtypes)
    lib.lp_batch_f64.restype = ctypes.c_int
    lib.lp_batch_ws_lane_bytes.restype = ctypes.c_int64
    return lib


def solver_on(lib, proto):
    """A LaneSolver of ``proto``'s class that launches ``lib``'s kernel."""
    sv = lp_batch.LaneSolver(proto.m_pad, proto.n_pad, proto.K_pad,
                             proto.max_iters, proto.refactor_every,
                             proto.device)
    sv.fn = lib.lp_batch_f64
    nb = lib.lp_batch_ws_lane_bytes(sv.m_pad, sv.N)
    sv.ws = torch.empty(sv.K_pad * nb, dtype=torch.uint8,
                        device=sv.device) if nb else None
    return sv


def kernel_ms(flights, reps: int) -> float:
    """Mean ms of ``reps`` rounds that launch every flight once."""
    for sv, cf, A, pack in flights:
        sv(cf, A, pack)                 # loads the in pack onto the card
    return cs.timed_ms(lambda: [sv._launch(cf, A, sv.max_iters)
                                for sv, cf, A, _ in flights], reps)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    src = (ROOT / "src/repro_torch/csrc/lp_batch.cu").read_text()
    ours = int(re.search(r"#define NS_MAX (\d+)", src)[1])
    libs = {f"shared columns (NS_MAX {ours})": build(ours),
            "global workspace (NS_MAX 0)": build(0)}
    print(cs.smi(), flush=True)
    dev = torch.device("cuda")
    from repro_torch.core.ilp import solve_ilp
    from repro_torch.core.lp_batch import solve_lp_batch

    bb = cs.LP_BNB
    c, A, bl, bu = cs.lp_instance(bb["seed"], bb["n"], bb["width"])
    with cs.capturing_flights() as bnb:
        solve_ilp(c, A, bl, bu, np.ones(bb["n"]), wave_width=bb["wave_width"],
                  max_nodes=bb["max_nodes"], time_limit_s=600.0, device=dev)
    cr, Ar, blr, bur = cs.lp_instance(9, cs.LP_RUNGS["n"], 2.0)
    ubs, lp1 = cs.rung_flight(cr, Ar, blr, bur,
                              np.full(cs.LP_RUNGS["n"], 3.0),
                              cs.LP_RUNGS["rungs"], cs.LP_RUNGS["q"])
    with cs.capturing_flights() as rungs:
        solve_lp_batch(cr, Ar, blr, bur, ubs, warm_starts=[lp1] * len(ubs),
                       backend="device", device=dev)
    valid = lambda f: int(np.count_nonzero(               # noqa: E731
        f[3][:, 3 * f[0].N + 1 + f[0].m_pad]))
    big = max(bnb, key=valid)
    cases = {f"bnb W=64, all {len(bnb)} flights (N={big[0].N})": (bnb, 5),
             f"bnb largest flight ({valid(big)} lanes, N={big[0].N})":
                 ([big], 50),
             f"rungs ({valid(rungs[0])} lanes, N={rungs[0][0].N})":
                 (rungs, 50)}
    for case, (flights, reps) in cases.items():
        per = {name: [(solver_on(lib, f[0]), f[1], f[2], f[3])
                      for f in flights] for name, lib in libs.items()}
        for name, fl in per.items():        # identical out packs
            for (sv, cf, A_, pack), f in zip(fl, flights):
                got = sv(cf, A_, pack)
                cs.check(np.array_equal(got, f[4], equal_nan=True),
                         f"{case}: {name} differs from the source's kernel")
        order = list(per.items())
        times = {name: [] for name in per}
        for rnd in range(2):
            for name, fl in order if rnd == 0 else order[::-1]:
                times[name].append(kernel_ms(fl, reps))
        for name, ms in times.items():
            print(json.dumps({"case": case, "variant": name, "reps": reps,
                              "ms_rounds": ms,
                              "ms_mean": float(np.mean(ms))}), flush=True)


if __name__ == "__main__":
    main()
