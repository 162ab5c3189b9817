"""The seed scan alone on the card: ``chip_smoke.py``'s phase "heap seed".

Builds ``csrc/dlv_scan.cu`` (ptxas's report of registers and spills
printed), then runs the heap-seed build on 1M TPC-H rows (every call held
bit-equal to ``dlv_scan_seed_plain``, the replaced serial kernel too; the
build's summed seed-kernel device ms and wall beside the same build
through the replaced kernel) and the "kernel dlv_scan_seed[...]" lines for
its first span and the fixed 1M-row span, as the full script prints them;
then a 17M-row normal span (more than one chunk of tile totals, windows
of ~600k rows) timed the same way beside the replaced kernel, without
the plain version.

    python3 scripts/seed_scan_probe.py        # needs one CUDA card
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("seed_scan_probe: needs a CUDA card")
    import chip_smoke
    from repro_torch.kernels import _build, dlv_scan
    print(chip_smoke.smi(), flush=True)
    t0 = time.perf_counter()
    _build.load("dlv_scan", dlv_scan._SIG)
    print(f"build dlv_scan: {time.perf_counter() - t0:.1f} s", flush=True)
    log = _build.build_log("dlv_scan").splitlines()
    for i, line in enumerate(log):       # each seed kernel's report
        if "Compiling entry" in line and "dlv_scan_seed" in line:
            for rep in log[i:i + 4]:
                print("ptxas", rep.strip(), flush=True)
    X = chip_smoke.heap_table(chip_smoke.HEAP["rows"])
    chip_smoke.phase_heap_seed(X, "cuda")
    v = np.sort(np.random.default_rng(17).normal(0.0, 2.0, 17_000_000))
    v = v - v.mean()
    beta = 13.5 * float(v.var()) / chip_smoke.HEAP["d_f"] ** 2
    chip_smoke.say("kernel dlv_scan_seed[17M]", **chip_smoke.seed_numbers(
        torch.as_tensor(v, device="cuda"), beta, None))


if __name__ == "__main__":
    main()
