"""Package-query admission control for serving (port of
``repro.serving.scheduler``) — the paper's technique in the serving tier.

Every scheduling tick, the waiting-request pool is a relation (one row per
request: priority, prefill FLOPs, KV-cache bytes) and batch formation IS
a package query:

    SELECT PACKAGE(*) FROM queue REPEAT 0
    SUCH THAT COUNT(P.*) <= max_batch
          AND SUM(P.kv_bytes)      <= hbm_budget
          AND SUM(P.prefill_flops) <= flop_budget
    MAXIMIZE  SUM(P.priority)

solved with the port's Dual Reducer: host numpy, as in the reference,
except the sub-ILP's B&B waves (``wave_width``, default 8), which run as
batched LP flights on ``device`` (default ``"cuda"``; the serving engine
passes its model's device).
The feature table is kept incrementally: columns are appended once at
``submit`` and mask-compacted on admission.  Each tick solves under a
``guard.SolveBudget`` deadline and contains any solver exception into an
ERROR report (empty admission), so the serving loop never raises and
never hangs; the last ``guard.SolveReport`` is kept on ``last_report``.
The lock discipline is the reference's: pool state under ``_lock``, whole
ticks serialised on ``_tick_lock``, the solve run with ``_lock`` released.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.dual_reducer import dual_reducer
from repro_torch.core.guard import ERROR, NumericalMonitor, SolveBudget, \
    SolveReport
from repro_torch.core.paql import Constraint, PackageQuery
from repro_torch.device import resolve_device


@dataclasses.dataclass
class Request:
    rid: int
    prompt_tokens: int
    max_new_tokens: int
    priority: float

    def kv_bytes(self, cfg) -> float:
        """The self-attention K/V cache in bf16, as the reference counts it
        (an encoder-decoder's cross cache is not counted)."""
        per_tok = 2 * 2 * cfg.num_kv_heads * cfg.resolved_head_dim \
            * cfg.num_layers
        return float(per_tok * (self.prompt_tokens + self.max_new_tokens))

    def prefill_flops(self, cfg) -> float:
        n_active = cfg.active_param_count()
        return float(2 * n_active * self.prompt_tokens)


_COLUMNS = ("priority", "kv_bytes", "prefill_flops")


class _ColumnStore:
    """Growable column arrays for the waiting pool: appended on ``submit``
    (capacity doubles), compacted by a boolean mask on admission."""

    def __init__(self, capacity: int = 64):
        self._cap = max(int(capacity), 1)
        self._len = 0
        self._cols = {k: np.zeros(self._cap) for k in _COLUMNS}

    def append(self, priority: float, kv: float, flops: float) -> None:
        if self._len == self._cap:
            self._cap *= 2
            for k, old in self._cols.items():
                buf = np.zeros(self._cap)
                buf[:self._len] = old[:self._len]
                self._cols[k] = buf
        row = {"priority": priority, "kv_bytes": kv, "prefill_flops": flops}
        for k in _COLUMNS:
            self._cols[k][self._len] = row[k]
        self._len += 1

    def snapshot(self, n: int) -> Dict[str, np.ndarray]:
        """Copied column prefix of length ``n``, safe to read after the
        caller drops the lock."""
        return {k: v[:n].copy() for k, v in self._cols.items()}

    def compact(self, keep: np.ndarray) -> None:
        """Drop rows where ``keep`` is False (in place, order-preserving)."""
        kept = int(np.count_nonzero(keep))
        for v in self._cols.values():
            v[:kept] = v[:self._len][keep]
        self._len = kept


class PackageScheduler:

    __guarded_by__ = {"queue": "_lock", "_store": "_lock",
                      "_admitted_total": "_lock", "last_report": "_lock",
                      "rng": "_tick_lock"}

    def __init__(self, cfg, *, hbm_budget_bytes: float,
                 flop_budget: float, max_batch: int = 64, seed: int = 0,
                 time_limit_s: float = 5.0, wave_width: int = 8,
                 device="cuda"):
        self.cfg = cfg
        self.hbm_budget = hbm_budget_bytes
        self.flop_budget = flop_budget
        self.max_batch = max_batch
        self.time_limit_s = time_limit_s
        self.wave_width = wave_width
        self.device = resolve_device(device)
        self.queue: List[Request] = []
        self.rng = np.random.default_rng(seed)
        self._store = _ColumnStore()
        self._admitted_total = 0
        self.last_report: Optional[SolveReport] = None
        self._lock = threading.Lock()
        self._tick_lock = threading.Lock()

    def submit(self, req: Request):
        with self._lock:
            self.queue.append(req)
            self._store.append(req.priority, req.kv_bytes(self.cfg),
                               req.prefill_flops(self.cfg))

    def tick(self) -> List[Request]:
        """Admit the optimal batch; admitted requests leave the queue.

        Never raises and never hangs.  The tick solves over a snapshot of
        the first ``n`` pool rows taken under the data lock, runs the
        solver with the data lock released (submits go on), then removes
        the admitted rows under the lock again; rows appended mid-solve
        wait for the next tick.
        """
        with self._tick_lock:
            with self._lock:
                n = len(self.queue)
                if n == 0:
                    return []
                cols = self._store.snapshot(n)
            query = PackageQuery(
                "priority", maximize=True,
                constraints=(
                    Constraint(None, 0, self.max_batch),
                    Constraint("kv_bytes", hi=self.hbm_budget),
                    Constraint("prefill_flops", hi=self.flop_budget),
                ))
            budget = SolveBudget(deadline_s=self.time_limit_s).start()
            report = SolveReport(budget=budget, monitor=NumericalMonitor())
            try:
                res = dual_reducer(query, cols, np.arange(n),
                                   q=min(500, n), rng=self.rng,
                                   budget=budget, report=report,
                                   device=self.device,
                                   ilp_kwargs=dict(
                                       max_nodes=200,
                                       wave_width=self.wave_width))
            # containment by design: the tick contract is "never raises";
            # a failure becomes an ERROR report and an empty admission
            except Exception as exc:   # pragma: no cover - containment
                report.status = ERROR
                report.note(f"scheduler tick contained: "
                            f"{type(exc).__name__}: {exc}")
                with self._lock:
                    self.last_report = report
                return []
            with self._lock:
                self.last_report = report.finalize(res.feasible)
                if not res.feasible:
                    return []   # nothing admissible this tick
                take = set(int(i) for i in res.idx)
                # the pool may have grown mid-solve: rows >= n are kept
                keep = np.ones(len(self.queue), bool)
                keep[list(take)] = False
                admitted = [r for i, r in enumerate(self.queue)
                            if i in take]
                self.queue = [r for i, r in enumerate(self.queue)
                              if i not in take]
                self._store.compact(keep)
                self._admitted_total += len(admitted)
            return admitted

    @property
    def admitted_total(self) -> int:
        with self._lock:
            return self._admitted_total
