#!/usr/bin/env python3
"""Where the one-CTA BFRT select spends its cycles, on the main path's
inputs.

    python3 scripts/bfrt_phase_cycles.py

Needs one CUDA card and ``nvcc``.  Writes a copy of
``src/repro_torch/csrc/bfrt.cu`` whose ``bfrt_select_one`` has thread 0
read ``clock64()`` after a barrier at each phase boundary (edges and pass
1, the crossing bucket, compaction, sort and walk, flip mask), builds it
into ``build/probe/``, reruns ``chip_smoke.main_path`` keeping every
select call's inputs, runs the copy three times on each and prints one
line per call (N, the crossing bucket's size k, the finite ratios, the
cycles of each phase) and the mean.  The barriers the stamps add are
inside the phases they close.
"""
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
from repro_torch.core.hardness import (Q2_TPCH, column_stats,  # noqa: E402
                                       instantiate)
from repro_torch.data.synth_tables import make_table       # noqa: E402
from repro_torch.kernels import _build, bfrt               # noqa: E402

PHASES = ["edges+pass1", "crossing bucket", "compaction", "sort+walk",
          "flips"]


def stamp(i: int) -> str:
    return (f"  __syncthreads(); if (threadIdx.x == 0) "
            f"g_stamp[g_call * 8 + {i}] = clock64();\n")


def build() -> ctypes.CDLL:
    src = (ROOT / "src/repro_torch/csrc/bfrt.cu").read_text()
    head, one = src.split("__global__ void __launch_bounds__(ONE_THREADS)\n"
                          "bfrt_select_one", 1)
    body, rest = one.split("// ---- the grid path", 1)
    marks = ["  if (threadIdx.x < NBK) e_s[threadIdx.x] = edge(",
             "  if (threadIdx.x < 32) find_bucket(",
             "  const double lo = cr.lo, hi = cr.hi;\n",
             "  const int* sorted;\n", "  const double rq = ratio[q];\n"]
    for i, mark in enumerate(marks):
        assert body.count(mark) == 1, mark
        body = body.replace(mark, stamp(i) + mark)
    body = body.rstrip().rstrip("}") + stamp(5) + "}\n\n"
    head = head.replace("typedef unsigned long long u64;",
                        "typedef unsigned long long u64;\n"
                        "__device__ long long g_stamp[8 * 4096];\n"
                        "__device__ int g_call;")
    out = (head + "__global__ void __launch_bounds__(ONE_THREADS)\n"
           "bfrt_select_one" + body + "// ---- the grid path" + rest + '''
extern "C" int bfrt_stamps(long long* host, int call) {
  cudaMemcpyToSymbol(g_call, &call, sizeof(int));
  if (host) cudaMemcpyFromSymbol(host, g_stamp, sizeof(long long) * 8 * 4096);
  return (int)cudaGetLastError();
}
''')
    probe = ROOT / "build" / "probe"
    probe.mkdir(parents=True, exist_ok=True)
    (probe / "bfrt_stamped.cu").write_text(out)
    subprocess.run([_build._nvcc(), *_build.BASE_FLAGS, "-o",
                    str(probe / "libbfrt_stamped.so"),
                    str(probe / "bfrt_stamped.cu")], check=True)
    lib = ctypes.CDLL(str(probe / "libbfrt_stamped.so"))
    lib.bfrt_select_f64.argtypes = [ctypes.c_void_p]
    lib.bfrt_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    _build.check(lib.bfrt_select_init(), "bfrt_select_init")
    return lib


def main() -> None:
    lib = build()
    table = make_table("tpch", 10_000_000, seed=0)
    stats = column_stats(table, cs.ATTRS)
    q3, q5 = (instantiate(Q2_TPCH, stats, h) for h in (3, 5))
    with cs.capturing(("bfrt_histogram",)) as calls:
        cs.main_path(table, q3, q5, 100_000, "cuda")
    dev = torch.device("cuda")
    rows = []
    for i, ((_, r, c, b), kw) in enumerate(calls["bfrt_histogram"]):
        N = r.shape[0]
        q = torch.zeros(1, dtype=torch.int64, device=dev)
        hc = torch.zeros(1, dtype=torch.bool, device=dev)
        flips = torch.zeros(N, dtype=torch.bool, device=dev)
        args = (ctypes.c_int64 * bfrt._ARGS)(
            r.data_ptr(), c.data_ptr(), kw["rng"].data_ptr(), b.data_ptr(),
            N, q.data_ptr(), flips.data_ptr(), hc.data_ptr(), 0,
            _build.stream_ptr(dev), 0)
        for _ in range(3):
            _build.check(lib.bfrt_stamps(None, i), "bfrt_stamps")
            _build.check(lib.bfrt_select_f64(args), "bfrt_select")
        _, finite, _, inb, _ = bfrt._bucket(r, c, b, bfrt.NUM_BUCKETS,
                                            kw["rng"])
        rows.append((N, int(inb.sum()), int(finite.sum())))
    torch.cuda.synchronize()
    host = (ctypes.c_longlong * (8 * 4096))()
    _build.check(lib.bfrt_stamps(host, 0), "bfrt_stamps")
    cyc = np.array([np.diff([host[i * 8 + j] for j in range(6)])
                    for i in range(len(rows))])
    for (N, k, fin), d in zip(rows, cyc):
        print("phase cycles " + json.dumps(
            {"N": N, "k": k, "finite": fin,
             **dict(zip(PHASES, d.tolist())), "total": int(d.sum())}))
    print("phase cycles mean " + json.dumps(
        {"card": cs.smi(), "calls": len(rows),
         **dict(zip(PHASES, cyc.mean(0).tolist())),
         "total": float(cyc.sum(1).mean())}), flush=True)


if __name__ == "__main__":
    main()
