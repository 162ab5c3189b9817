#!/usr/bin/env python3
"""Where the batched LP kernel's trips spend their cycles, on the main
path's flights.

    python3 scripts/lp_batch_phase_cycles.py [--source PATH] [--no-full]
                                             [--cta]

Needs one CUDA card and ``nvcc``.  Writes a copy of ``--source`` (default
``src/repro_torch/csrc/lp_batch.cu``) into ``build/probe/`` with PROBE
defined: its hooks (``PROBE_CTA`` on the CTA-per-lane path, after a block
barrier; ``PROBE_WARP`` on the warp-per-lane path, after a warp barrier)
add the ``clock64()`` cycles since the last hook to the phase that ends
there, and every ``__syncthreads()`` / ``__syncwarp()`` is counted in the
phase it falls in.  Where the source has a warp path it also builds the
copy with ``WARP_N_MAX`` 0 (every flight on the CTA path).  It captures
the main path's flights (``chip_smoke.lp_main_flights``: the 113 of B&B
at W = 64 on the reference benchmark's instance, the Dual Reducer's rung
flight, the parity cell's flights (200k rows, B&B at W = 8) and, unless
``--no-full``, four rungs of the full cell's h=3 Dual Reducer LP, which
needs the 10M-row build) and, with ``--cta``, the CTA
path's flights of phase "lp batch" ("wide", 100,000 columns, and "tall",
40 rows: ``chip_smoke.lp_cta_flights``), launches each flight three
times on each build and prints one line per case, build and path: lanes,
trips, and per phase the cycles and the barriers per trip (summed over
the lanes, over their trips).  "out" is a lane's time outside its trips
(the eager and exit refreshes, the out pack).  The hooks' own barriers
are inside the phases they close; the hooks' cost is in the numbers.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np                                          # noqa: E402
import torch                                                # noqa: E402

import chip_smoke as cs                                     # noqa: E402
from repro_torch.kernels import _build, lp_batch            # noqa: E402

PHASES = ["gates", "refresh", "leave", "price", "collect", "sort", "walk",
          "flips", "pivot", "out"]
PATHS = ["cta", "warp"]
REPS = 3

HEADER = r"""
#define PROBE 1
__device__ unsigned long long g_cyc[2][16], g_bar[2][16], g_trips[2],
    g_lanes[2];
__shared__ long long pr_cyc[8][16], pr_last[8];
__shared__ int pr_bar[8][16], pr_pend[8];
__device__ __forceinline__ void pr_close(int w, int ph) {
  pr_cyc[w][ph] += clock64() - pr_last[w];
  pr_bar[w][ph] += pr_pend[w];
  pr_pend[w] = 0;
  pr_last[w] = clock64();
}
#define PROBE_INIT() do { if ((threadIdx.x & 31) == 0) {                  \
    const int w_ = threadIdx.x >> 5;                                       \
    for (int i_ = 0; i_ < 16; ++i_) { pr_cyc[w_][i_] = 0;                  \
                                      pr_bar[w_][i_] = 0; }                \
    pr_pend[w_] = 0; pr_last[w_] = clock64(); } __syncwarp(); } while (0)
#define PROBE_CTA(ph) do { asm volatile("bar.sync 0;" ::: "memory");       \
    if (threadIdx.x == 0) pr_close(0, ph); } while (0)
#define PROBE_WARP(ph) do { __syncwarp();                                  \
    if ((threadIdx.x & 31) == 0) pr_close(threadIdx.x >> 5, ph); } while (0)
#define PROBE_BAR() do { if (threadIdx.x == 0) ++pr_pend[0];               \
    asm volatile("bar.sync 0;" ::: "memory"); } while (0)
#define PROBE_WBAR() do { if ((threadIdx.x & 31) == 0)                     \
    ++pr_pend[threadIdx.x >> 5]; __syncwarp(); } while (0)
#define PROBE_END(path, trips) do { if ((threadIdx.x & 31) == 0            \
    && (path || threadIdx.x == 0)) {                                       \
    const int w_ = (path) ? threadIdx.x >> 5 : 0;                          \
    for (int i_ = 0; i_ < 16; ++i_) {                                      \
      atomicAdd(&g_cyc[path][i_], (unsigned long long)pr_cyc[w_][i_]);     \
      atomicAdd(&g_bar[path][i_], (unsigned long long)pr_bar[w_][i_]); }   \
    atomicAdd(&g_trips[path], (unsigned long long)(trips));                \
    atomicAdd(&g_lanes[path], 1ull); } } while (0)
"""

FOOTER = r"""
extern "C" int lp_probe(unsigned long long* host, int reset) {
  if (host) {
    cudaMemcpyFromSymbol(host, g_cyc, sizeof(g_cyc));
    cudaMemcpyFromSymbol(host + 32, g_bar, sizeof(g_bar));
    cudaMemcpyFromSymbol(host + 64, g_trips, sizeof(g_trips));
    cudaMemcpyFromSymbol(host + 66, g_lanes, sizeof(g_lanes));
  }
  if (reset) {
    static unsigned long long zero[32] = {0};
    cudaMemcpyToSymbol(g_cyc, zero, sizeof(g_cyc));
    cudaMemcpyToSymbol(g_bar, zero, sizeof(g_bar));
    cudaMemcpyToSymbol(g_trips, zero, sizeof(g_trips));
    cudaMemcpyToSymbol(g_lanes, zero, sizeof(g_lanes));
  }
  return (int)cudaGetLastError();
}
"""


def build(source: Path, tag: str, defines=()) -> ctypes.CDLL:
    src = source.read_text()
    body = (src.replace("__syncthreads();", "PROBE_BAR();")
            .replace("__syncwarp();", "PROBE_WBAR();"))
    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"lp_batch_probe_{tag}.cu"
    so = out / f"liblp_batch_probe_{tag}.so"
    cu.write_text(HEADER + body + FOOTER)
    subprocess.run([_build._nvcc(), *_build.BASE_FLAGS,
                    *_build.EXTRA_FLAGS["lp_batch"], *defines, "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in lp_batch._SIG.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
    lib.lp_batch_ws_lane_bytes.restype = ctypes.c_int64
    lib.lp_probe.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def solver_on(lib, proto):
    """A LaneSolver of ``proto``'s class that launches ``lib``'s kernel."""
    sv = lp_batch.LaneSolver(proto.m_pad, proto.n_pad, proto.K_pad,
                             proto.max_iters, proto.refactor_every,
                             proto.device)
    if hasattr(lib, "lp_batch_plan"):
        sv._bind(lib)
    else:                           # a source of one path (a CTA-only kernel)
        sv.fn = lib.lp_batch_f64
        nb = lib.lp_batch_ws_lane_bytes(sv.m_pad, sv.N)
        sv.ws = torch.empty(sv.K_pad * nb, dtype=torch.uint8,
                            device=sv.device) if nb else None
    return sv


def probe(lib, flights) -> dict:
    """Per path: lanes, trips and per phase cycles and barriers per trip,
    over REPS launches of every flight."""
    solvers = [(solver_on(lib, f[0]), f[1], f[2], f[3]) for f in flights]
    for sv, cf, A, pack in solvers:
        sv(cf, A, pack)                        # the in pack onto the card
    torch.cuda.synchronize()
    _build.check(lib.lp_probe(None, 1), "lp_probe")
    for _ in range(REPS):
        for sv, cf, A, _ in solvers:
            sv._launch(cf, A, sv.max_iters)
    torch.cuda.synchronize()
    host = (ctypes.c_ulonglong * 68)()
    _build.check(lib.lp_probe(host, 0), "lp_probe")
    h = np.array(host[:], dtype=np.float64)
    res = {}
    for p, path in enumerate(PATHS):
        lanes, trips = h[66 + p] / REPS, h[64 + p] / REPS
        if not lanes:
            continue
        cyc = h[p * 16:p * 16 + len(PHASES)] / REPS / max(trips, 1)
        bar = h[32 + p * 16:32 + p * 16 + len(PHASES)] / REPS / max(trips, 1)
        res[path] = {"lanes": lanes, "trips": trips,
                     "cycles_per_trip": dict(zip(PHASES, cyc.tolist())),
                     "cycles_per_trip_in_trips": float(cyc[:-1].sum()),
                     "barriers_per_trip": dict(zip(PHASES, bar.tolist())),
                     "barriers_per_trip_in_trips": float(bar[:-1].sum())}
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", type=Path,
                    default=ROOT / "src/repro_torch/csrc/lp_batch.cu")
    ap.add_argument("--no-full", action="store_true")
    ap.add_argument("--cta", action="store_true",
                    help="also the CTA path's flights: wide and tall")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    libs = {"source": build(args.source, "source")}
    if "WARP_N_MAX" in args.source.read_text():
        libs["cta path only (WARP_N_MAX 0)"] = build(
            args.source, "cta", ("-DWARP_N_MAX=0",))
    print(cs.smi(), flush=True)
    flights = cs.lp_main_flights(torch.device("cuda"), full=not args.no_full)
    if args.cta:
        flights.update(cs.lp_cta_flights(torch.device("cuda")))
    valid = lambda f: int(np.count_nonzero(               # noqa: E731
        f[3][:, 3 * f[0].N + 1 + f[0].m_pad]))
    bnb = flights.pop("bnb")
    big = max(bnb, key=valid)
    cases = {f"bnb W=64, all {len(bnb)} flights (N={big[0].N})": bnb,
             f"bnb largest flight ({valid(big)} lanes, N={big[0].N})": [big]}
    cases.update({f"{k} ({valid(v[0])} lanes, N={v[0][0].N})": v
                  for k, v in flights.items()})
    for case, fl in cases.items():
        for name, lib in libs.items():
            for path, r in probe(lib, fl).items():
                print("phase cycles " + json.dumps(
                    {"case": case, "build": name, "path": path, **r}),
                    flush=True)


if __name__ == "__main__":
    main()
