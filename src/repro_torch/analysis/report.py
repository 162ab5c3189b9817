"""Violation model, baseline ratchet, and the machine-readable report
(port of ``repro.analysis.report``; the JSON keeps its keys).

Shared by the port's analysis layers (``analysis.contracts`` -- traced
contracts on the hot paths, ``analysis.lint`` and
``analysis.concurrency`` -- the AST passes) and the
``python -m repro_torch.analysis`` CLI:

* :class:`Violation` -- one finding, addressed by ``rule:path`` (line
  numbers drift, so the baseline pins *counts per (rule, path)*, not
  positions).
* :func:`compare_baseline` -- the ratchet.  New violations (any
  ``rule:path`` count above its pinned value, or an unpinned key) fail;
  pinned violations are tolerated; a shrunk count is reported so the
  baseline can be re-pinned smaller (``--update-baseline``), never
  larger.
* :func:`write_report` -- ``build/analysis_torch.json`` by default:
  every violation, the per-hot-path contract records (collective bytes
  against declared budgets, host reads and dense passes a pivot, wall
  time) and the baseline delta.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

BASELINE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding from either layer.

    ``rule``  — lint rule id (``REPRO001``..) or contract id (``IRC00x``);
    ``path``  — repo-relative file path (lint) or hot-path name like
    ``distributed.update_step@w2`` (contracts);
    ``line``  — 1-based source line (0 for contract findings).
    """
    rule: str
    path: str
    line: int
    message: str

    @property
    def key(self) -> str:
        """Baseline key: stable under line drift and message rewording."""
        return f"{self.rule}:{self.path}"

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: {self.rule}: {self.message}"


def count_by_key(violations: Sequence[Violation]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for v in violations:
        out[v.key] = out.get(v.key, 0) + 1
    return out


# -------------------------------------------------------------- baseline


def load_baseline(path: str) -> Dict[str, int]:
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or "pinned" not in data:
        raise ValueError(f"{path}: not a baseline file "
                         "(expected {'version': 1, 'pinned': {...}})")
    return {str(k): int(v) for k, v in data["pinned"].items()}


def save_baseline(path: str, pinned: Dict[str, int]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"version": BASELINE_VERSION,
                   "pinned": dict(sorted(pinned.items()))}, f, indent=1,
                  sort_keys=False)
        f.write("\n")


def compare_baseline(violations: Sequence[Violation],
                     pinned: Dict[str, int]
                     ) -> Tuple[List[Violation], List[str], List[str]]:
    """Ratchet comparison.

    Returns ``(new, shrunk, stale)``: ``new`` is every violation beyond
    its pinned count (these fail the gate); ``shrunk`` lists keys whose
    count dropped below the pin; ``stale`` lists pinned keys with no
    remaining violations at all.  Shrunk/stale keys never fail — they are
    the ratchet's progress signal (re-pin with ``--update-baseline``).
    """
    seen: Dict[str, int] = {}
    new: List[Violation] = []
    for v in violations:
        seen[v.key] = seen.get(v.key, 0) + 1
        if seen[v.key] > pinned.get(v.key, 0):
            new.append(v)
    cur = count_by_key(violations)
    shrunk = sorted(k for k, n in pinned.items() if 0 < cur.get(k, 0) < n)
    stale = sorted(k for k, n in pinned.items() if cur.get(k, 0) == 0)
    return new, shrunk, stale


# ---------------------------------------------------------------- report


def write_report(out_path: str, *,
                 grid: str,
                 lint_violations: Sequence[Violation],
                 contract_violations: Sequence[Violation],
                 contract_records: Sequence[dict],
                 files_linted: int,
                 baseline_path: Optional[str] = None,
                 new: Optional[Sequence[Violation]] = None,
                 shrunk: Optional[Sequence[str]] = None,
                 stale: Optional[Sequence[str]] = None,
                 wall_s: Optional[Dict[str, float]] = None,
                 exit_code: int = 0) -> dict:
    rep = {
        "grid": grid,
        "exit_code": int(exit_code),
        "lint": {
            "files": int(files_linted),
            "violations": [dataclasses.asdict(v) for v in lint_violations],
            "by_rule": _by_rule(lint_violations),
        },
        "contracts": {
            "violations": [dataclasses.asdict(v)
                           for v in contract_violations],
            "hot_paths": list(contract_records),
        },
        "wall_s": dict(wall_s or {}),
    }
    if baseline_path is not None:
        rep["baseline"] = {
            "path": baseline_path,
            "new": [v.format() for v in (new or [])],
            "shrunk": list(shrunk or []),
            "stale": list(stale or []),
        }
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rep, f, indent=1)
        f.write("\n")
    return rep


def _by_rule(violations: Sequence[Violation]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for v in violations:
        out[v.rule] = out.get(v.rule, 0) + 1
    return dict(sorted(out.items()))
