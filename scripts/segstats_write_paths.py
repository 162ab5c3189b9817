#!/usr/bin/env python3
"""How the segment stats kernel should write out the runs a step closes.

    python3 scripts/segstats_write_paths.py

Needs one CUDA card and ``nvcc``.  ``csrc/segstats.cu`` writes a step's
closed runs out by the whole warp in row order (consecutive groups on
consecutive lanes) when more than ``DENSE_LANES`` of its 32 lanes closed
one, else each lane writes its own.  This builds copies of the source
into ``build/probe/`` with that bar at -1 (always the warp), the
source's value, and 32 (always each lane), checks each bit-equal to
``segment_stats_tiled_plain``, and times them in turns at 10M x 4 rows
under four sortings: one group, 100k groups (~100 rows each), 1M groups
(~10 rows), and every row its own group.  One line per sorting and
variant: the mean ms of 20 back-to-back calls, in two rounds in opposite
order.
"""
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np                                          # noqa: E402
import torch                                                # noqa: E402

import chip_smoke as cs                                     # noqa: E402
from repro_torch.kernels import _build, segstats            # noqa: E402

SORTINGS = ("G=1", "G=100k", "G=1000k", "G=n")


def build(bar: int) -> ctypes.CDLL:
    src = (ROOT / "src/repro_torch/csrc/segstats.cu").read_text()
    src, hits = re.subn(r"#define DENSE_LANES \d+",
                        f"#define DENSE_LANES {bar}", src)
    assert hits == 1
    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"segstats_dense{bar}.cu"
    so = out / f"libsegstats_dense{bar}.so"
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.BASE_FLAGS,
                    *_build.EXTRA_FLAGS["segstats"], "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.segstats_f64.argtypes = list(segstats._SIG["segstats_f64"])
    lib.segstats_f64.restype = ctypes.c_int
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    src = (ROOT / "src/repro_torch/csrc/segstats.cu").read_text()
    ours = int(re.search(r"#define DENSE_LANES (\d+)", src)[1])
    variants = {"always the warp (bar -1)": build(-1),
                f"the source's (bar {ours})": build(ours),
                "always each lane (bar 32)": build(32)}
    print(cs.smi(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    for case in SORTINGS:
        vals, ids, G = cs.segstats_case(rng, case, 10_000_000, dev)
        n, k = vals.shape
        T = segstats.tile_rows(k)
        want = segstats.segment_stats_tiled_plain(vals, ids, G)
        cnt = torch.empty(G, dtype=torch.float64, device=dev)
        sm = torch.empty((G, k), dtype=torch.float64, device=dev)
        sq = torch.empty_like(sm)
        rec = torch.empty(-(-n // T) * 2 * (2 + 2 * k), dtype=torch.float64,
                          device=dev)
        order = list(variants.items())
        for rnd in range(2):
            for name, lib in order if rnd == 0 else order[::-1]:
                def call():
                    _build.check(lib.segstats_f64(
                        vals.data_ptr(), ids.data_ptr(), n, k, G, T,
                        cnt.data_ptr(), sm.data_ptr(), sq.data_ptr(),
                        rec.data_ptr(), _build.stream_ptr(dev)), name)
                call()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b)
                           for a, b in zip((cnt, sm, sq), want)):
                    sys.exit(f"{name} differs from the mirror on {case}")
                print(f"segstats write path[{case}]: variant={name!r} "
                      f"round={rnd} ms={cs.timed_ms(call, 20)}", flush=True)


if __name__ == "__main__":
    main()
