"""CLI: ``python -m repro_torch.analysis`` — run the port's analysis layers
(lint, concurrency, traced contracts), apply the baseline ratchet, emit
``build/analysis_torch.json``, exit non-zero on any new violation (2 when
``--update-baseline`` would grow a pin).

  python -m repro_torch.analysis                     # host grid + lint
  python -m repro_torch.analysis --grid none         # lint only
  python -m repro_torch.analysis --grid card         # contracts on CUDA
  python -m repro_torch.analysis \
      --baseline src/repro_torch/analysis/baseline.json
  python -m repro_torch.analysis --update-baseline ...  # shrink only
"""
import argparse
import os
import sys
import time


def _parse(argv):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="traced contract checks + project lint of the port")
    ap.add_argument("--grid", choices=("host", "card", "none"),
                    default="host",
                    help="where the traced contracts run: 'host' = the "
                         "CPU (a world of one rank and a spawned gloo "
                         "world of two; default), 'card' = CUDA (a world "
                         "of one rank on NCCL), 'none' = lint only")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON (ratchet: new violations fail, "
                         "pinned ones must only shrink)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite --baseline to the current violation "
                         "set (refuses to grow an existing pin)")
    ap.add_argument("--out", default="build/analysis_torch.json",
                    help="machine-readable report path")
    ap.add_argument("--root", default=".",
                    help="repo root (lint paths are relative to it)")
    ap.add_argument("--lint-dir", action="append", default=None,
                    help="lint target (repeatable; default: "
                         "src/repro_torch, chip_smoke.py)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(sys.argv[1:] if argv is None else argv)

    from repro_torch.analysis import concurrency, lint, report

    wall = {}
    t0 = time.time()
    lint_dirs = args.lint_dir or [
        d for d in lint.DEFAULT_LINT_DIRS
        if os.path.exists(os.path.join(args.root, d))]
    lint_violations, files_linted = lint.lint_paths(lint_dirs,
                                                    root=args.root)
    wall["lint"] = round(time.time() - t0, 3)
    print(f"[analysis] lint: {files_linted} files, "
          f"{len(lint_violations)} violations ({wall['lint']}s)")

    # concurrency contracts ride the lint bucket (same suppression /
    # ratchet machinery); they run in every grid mode incl. 'none'.
    t0 = time.time()
    conc_violations, _ = concurrency.check_paths(lint_dirs,
                                                 root=args.root)
    lint_violations = list(lint_violations) + list(conc_violations)
    wall["concurrency"] = round(time.time() - t0, 3)
    print(f"[analysis] concurrency: {files_linted} files, "
          f"{len(conc_violations)} violations "
          f"({wall['concurrency']}s)")

    contract_violations = []
    records = []
    if args.grid != "none":            # 'none' = lint only, no torch import
        from repro_torch.analysis import contracts
        contract_violations, records, wall_c = contracts.run_contracts(
            args.grid)
        wall["contracts"] = round(wall_c, 3)
        print(f"[analysis] contracts ({args.grid} grid): "
              f"{len(records)} hot paths, "
              f"{len(contract_violations)} violations "
              f"({wall['contracts']}s)")

    violations = list(lint_violations) + list(contract_violations)

    new, shrunk, stale = violations, [], []
    if args.baseline and os.path.exists(args.baseline) \
            and not args.update_baseline:
        pinned = report.load_baseline(args.baseline)
        new, shrunk, stale = report.compare_baseline(violations, pinned)
        pinned_n = len(violations) - len(new)
        print(f"[analysis] baseline {args.baseline}: {len(new)} new, "
              f"{pinned_n} pinned, {len(shrunk)} shrunk, "
              f"{len(stale)} stale")
        for k in shrunk:
            print(f"[analysis]   shrunk: {k} (re-pin with "
                  "--update-baseline)")
        for k in stale:
            print(f"[analysis]   stale pin: {k} (re-pin with "
                  "--update-baseline)")

    if args.update_baseline:
        if not args.baseline:
            print("[analysis] --update-baseline requires --baseline",
                  file=sys.stderr)
            return 2
        cur = report.count_by_key(violations)
        if os.path.exists(args.baseline):
            pinned = report.load_baseline(args.baseline)
            grew = sorted(k for k, v in cur.items()
                          if v > pinned.get(k, 0))
            if grew:
                print("[analysis] refusing to GROW the baseline; fix or "
                      "suppress these first:", file=sys.stderr)
                for k in grew:
                    print(f"  {k}: {pinned.get(k, 0)} -> {cur[k]}",
                          file=sys.stderr)
                return 2
        report.save_baseline(args.baseline, cur)
        print(f"[analysis] baseline written: {args.baseline} "
              f"({len(cur)} keys)")
        new = []

    for v in new:
        print(f"  {v.format()}")
    exit_code = 1 if new else 0
    report.write_report(args.out, grid=args.grid,
                        lint_violations=lint_violations,
                        contract_violations=contract_violations,
                        contract_records=records,
                        files_linted=files_linted,
                        baseline_path=args.baseline,
                        new=new, shrunk=shrunk, stale=stale,
                        wall_s=wall, exit_code=exit_code)
    print(f"[analysis] report: {args.out}  ->  "
          f"{'FAIL' if exit_code else 'OK'}")
    return exit_code


if __name__ == "__main__":
    raise SystemExit(main())
