#!/usr/bin/env python3
"""The split-tree descent kernel's staging budgets and the kernel it
replaced, timed in one call on the fixed cases of ``chip_smoke.py``'s
phase 5c.

    python3 scripts/split_tree_layouts.py [--calls N]

Needs one CUDA card and ``nvcc``.  ``csrc/split_tree.cu`` walks the packed
layout of ``kernels/split_tree.py::pack_tree`` one row a thread, in
blocks of 1,024 threads, two an SM, with a prefix of the layout staged in
shared memory (``STAGE_BYTES``, 40 KB a block: the records, then the
fences, then the lines, each a breadth-first prefix).  This times it at
four staging budgets (none, 16, 40 and 48 KB, the most a block takes)
and, beside them, ``csrc/split_tree_bisect.cu`` (one thread a row
bisecting the tree's own arrays, ``descend_batch_bisect``), and prints
ptxas's registers and spills of the k = 4 descent kernel.  A variant of
the kernel's source is timed by editing it in a copy of the checkout and
running this there.

The cases: the full cell's 10M layer-0 rows down layer 1's tree (the
TPC-H stand-in, ``d_f`` 100, ``alpha`` 100,000), 100,000 fresh rows (the
append's, ``make_table`` seed 2) down the same tree, a KD-tree and a
bucketing partition of the first 1M rows.  Every run's leaves are checked
equal to the plain version's; each (kernel, budget) is timed by the
profiler's device ms per call over ``--calls`` calls (median, min, max)
and by CUDA events over the same number of back-to-back calls (host
launch gaps included), the runs in turns and then again in the opposite
order.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np                                          # noqa: E402
import torch                                                # noqa: E402

import chip_smoke as cs                                     # noqa: E402
from repro_torch.kernels import _build, split_tree          # noqa: E402

BUDGETS = {"none": 0, "16 KB": 16 * 1024, "40 KB": 40 * 1024,
           "48 KB": 48 * 1024}
BISECT = "bisection (csrc/split_tree_bisect.cu)"


def device_times(fn, kernel: str, calls: int) -> dict:
    """Device ms of the kernel ``kernel`` that ``fn`` launched over
    ``calls`` calls, from the profiler (median, min, max), and the events'
    ms per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ev_ms = cs.timed_ms(fn, calls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sorted(getattr(e, "self_device_time_total", 0.0)
                for e in prof.events() if e.device_type == DeviceType.CUDA
                and e.name.split("(")[0].split("<")[0].replace(
                    "void ", "") == kernel)
    if not us:
        return {"events_ms": ev_ms, "device_ms": None}
    return {"events_ms": ev_ms, "device_ms": us[len(us) // 2] / 1e3,
            "device_min": us[0] / 1e3, "device_max": us[-1] / 1e3,
            "kernels": len(us)}


def cases(dev):
    """{name: (rows on the card, packed tree)} of the timed cases."""
    from repro_torch.core import partitioner
    from repro_torch.core.engine import PackageQueryEngine
    from repro_torch.data.synth_tables import make_table
    table = make_table("tpch", 10_000_000, seed=0)
    eng = PackageQueryEngine(table, cs.ATTRS, d_f=100, alpha=100_000,
                             seed=0, device=dev)
    eng.partition()
    hier = eng.hierarchy
    X0 = hier.layers[0].X
    tree1 = hier.layers[1].part.tree
    fresh = make_table("tpch", 100_000, seed=2)
    R = np.stack([np.asarray(fresh[a], np.float64) for a in cs.ATTRS], 1)
    X1 = np.ascontiguousarray(X0[:1_000_000])
    kd = partitioner.fit(X1, backend="kdtree", d_f=100, device=dev)
    bk = partitioner.fit(X1, backend="bucketing", d_f=100,
                         memory_rows=250_000, device=dev)
    out = {}
    for name, tree, T in (("full layer 1, 10M", tree1, X0),
                          ("append rows, 100k", tree1, R),
                          ("kdtree 1M", kd.tree, X1),
                          ("bucketing 1M", bk.tree, X1)):
        packed = tree.device_packed(dev)
        out[name] = (torch.as_tensor(np.ascontiguousarray(T, np.float64),
                                     device=dev), packed)
        print(json.dumps({"case": name, "rows": T.shape[0],
                          "nodes": packed.num_nodes,
                          "bounds": int(packed.arrays[2].numel()),
                          "lines": int(packed.lines.shape[0]),
                          "depth": packed.depth}), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=21)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    _build.build_all()
    print(cs.smi(), flush=True)
    lines = _build.build_log("split_tree").splitlines()
    at = [i for i, ln in enumerate(lines) if "ILi4E" in ln
          and "Function properties" in ln]
    print(json.dumps({"ptxas_k4": [ln.strip() for ln in
                                   lines[at[0]:at[0] + 3]] if at
                      else None}), flush=True)
    dev = torch.device("cuda")
    for case, (Td, packed) in cases(dev).items():
        want = split_tree.descend_batch_plain(Td, *packed.arrays,
                                              packed.root)
        runs = {}
        for bname, budget in BUDGETS.items():
            p = split_tree.plan(packed, budget)
            got = split_tree._launch(Td, packed, p)
            cs.check(torch.equal(got, want), f"{case}: staging {bname} "
                     "differs from the plain version")
            runs[bname] = (lambda p=p: split_tree._launch(Td, packed, p),
                           "split_tree_descend", p)
        cs.check(torch.equal(split_tree.descend_batch_bisect(Td, packed),
                             want), f"{case}: the bisection kernel "
                 "differs from the plain version")
        runs[BISECT] = (lambda: split_tree.descend_batch_bisect(Td, packed),
                        "split_tree_bisect", None)
        order = list(runs.items())
        times = {key: [] for key in runs}
        for rnd in range(2):
            for key, (fn, kernel, _) in order if rnd == 0 else order[::-1]:
                times[key].append(device_times(fn, kernel, args.calls))
        for key, t in times.items():
            p = runs[key][2]
            print(json.dumps({
                "case": case, "kernel": runs[key][1],
                "budget": key if p else "none",
                "staging": p.staging if p else "none",
                "staged_bytes": p.smem if p else 0,
                "device_ms": [r["device_ms"] for r in t],
                "device_min": min(r.get("device_min", np.inf) for r in t),
                "device_max": max(r.get("device_max", 0.0) for r in t),
                "events_ms": [r["events_ms"] for r in t]}), flush=True)


if __name__ == "__main__":
    main()
