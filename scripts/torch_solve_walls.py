#!/usr/bin/env python3
"""Query walls of the PyTorch/CUDA port on one card, for one checkout.

    python3 scripts/torch_solve_walls.py [ROOT]

ROOT (default: this checkout) is a checkout of the repository whose
``chip_smoke.py`` and ``src/repro_torch`` are used.  Builds the kernels,
generates the 10M-row TPC-H table, runs ``chip_smoke.main_path`` once
(partition, Q2_TPCH at hardness 3 and 5 on the device LP), then solves h=3
and h=5 three times each and profiles one more h=3 solve.  Prints one
line, ``walls {...}``: the walls in seconds, the pivots of every solve,
the objectives, and the profiled solve's device busy ms, device ops, ops
per pivot and this repo's kernels' device ms and launches.  To compare
two commits, unpack the other one (``git archive``) into a directory and
run the two in turns in one session on one card: A, B, B, A.
"""
import json
import sys
from pathlib import Path

ROOT = Path(sys.argv[1] if len(sys.argv) > 1 else
            Path(__file__).resolve().parents[1]).resolve()
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs                                     # noqa: E402
from repro_torch.core.hardness import (Q2_TPCH, column_stats,  # noqa: E402
                                       instantiate)
from repro_torch.data.synth_tables import make_table       # noqa: E402
from repro_torch.kernels import _build                     # noqa: E402


def main() -> None:
    _build.build_all()
    table = make_table("tpch", 10_000_000, seed=0)
    stats = column_stats(table, cs.ATTRS)
    q3, q5 = (instantiate(Q2_TPCH, stats, h) for h in (3, 5))
    eng, r3, part_s, s3, r5, s5 = cs.main_path(table, q3, q5, 100_000,
                                                "cuda")
    out = {"root": str(ROOT), "card": cs.smi(), "partition_s": part_s,
           "first_h3_s": s3, "first_h5_s": s5, "obj3": r3.obj,
           "obj5": r5.obj, "feasible": [r3.feasible, r5.feasible]}
    for h, q in ((3, q3), (5, q5)):
        runs = [cs.solve(eng, q) for _ in range(3)]
        out[f"h{h}_s"] = [s for _, s in runs]
        out[f"h{h}_pivots"] = [r.ps_stats.lp_iters for r, _ in runs]
    res = []
    busy, ops, reads, ours, _ = cs.device_profile(
        lambda: res.append(cs.solve(eng, q3)[0]))
    pivots = res[0].ps_stats.lp_iters
    out.update(profile_busy_ms=busy, profile_ops=ops,
               profile_device_to_host=reads, profile_pivots=pivots,
               ops_per_pivot=ops / pivots, kernels=ours)
    print("walls " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
