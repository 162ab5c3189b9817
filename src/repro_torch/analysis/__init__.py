"""repro_torch.analysis — static analysis of the port (counterpart of
``repro.analysis``).

Three layers, one CLI (``python -m repro_torch.analysis``):

* :mod:`repro_torch.analysis.contracts` runs the registered hot paths
  (the distributed pq/update/refresh steps and ``solve_lp_dist``, the
  device LP's pivot loop, the batched LP engine, pricing, segment stats,
  the split-tree descent) under a traced op recorder and holds them to
  the port's declared counts: zero collectives in the update step,
  dense-pass discipline, only the declared host reads in the pivot
  loops, per-pivot collective bytes within budget, dtype preservation.
* :mod:`repro_torch.analysis.lint` is an AST pass encoding the repo's
  paid-for footgun classes as named REPRO rules in their torch form,
  with per-rule suppressions.
* :mod:`repro_torch.analysis.concurrency` extends the lint with the
  shared-state contracts of the serving path (REPRO008-012).

The CLI gates on a baseline ratchet
(``src/repro_torch/analysis/baseline.json``): new violations fail,
pinned ones must only shrink.  Importing this package imports no torch:
the contracts load only when a grid other than ``none`` runs.
"""
from repro_torch.analysis.report import (Violation, compare_baseline,
                                         count_by_key, load_baseline,
                                         save_baseline, write_report)
from repro_torch.analysis.lint import (RULES, lint_file, lint_paths,
                                       lint_source, DEFAULT_LINT_DIRS)
from repro_torch.analysis.concurrency import (ALL_RULES, CONCURRENCY_RULES,
                                              check_file, check_paths,
                                              check_source)

__all__ = [
    "Violation", "compare_baseline", "count_by_key", "load_baseline",
    "save_baseline", "write_report", "RULES", "lint_file", "lint_paths",
    "lint_source", "DEFAULT_LINT_DIRS", "ALL_RULES", "CONCURRENCY_RULES",
    "check_file", "check_paths", "check_source",
]
