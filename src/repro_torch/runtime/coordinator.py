"""Fleet coordinator: fault tolerance, straggler mitigation, elastic scale
(port of ``repro.runtime.coordinator``: pure Python, copied, since the
port imports nothing of the reference).

On a multi-host deployment each host runs a worker agent that heartbeats
this coordinator (which lives next to the job scheduler).  The tests drive
it against a virtual clock with injected failures
(``tests/test_torch_substrates.py``), but the state machine is the
production one:

  * heartbeats + timeout -> worker FAILED -> job enters RESHAPE: pick the
    largest feasible mesh from the survivors (elastic data-parallel width:
    batch must divide), restore the latest checkpoint on the new mesh
    (CheckpointManager.restore with new shardings), resume;
  * per-step deadline = straggler_factor x trailing-median step time;
    stragglers get WARN then, if persistent, are treated as failed
    (backup-worker takeover) — mitigating slow-host tail latency;
  * checkpoint cadence adapts: halves after a failure (down to min_cadence)
    and decays back to nominal after ``stable_steps`` clean steps.
"""
from __future__ import annotations

import dataclasses
import enum
import statistics
from typing import Dict, List, Optional, Tuple


class WorkerState(enum.Enum):
    HEALTHY = "healthy"
    STRAGGLER = "straggler"
    FAILED = "failed"


class JobPhase(enum.Enum):
    RUNNING = "running"
    RESHAPING = "reshaping"
    RESTORING = "restoring"


@dataclasses.dataclass
class Worker:
    wid: int
    last_heartbeat: float = 0.0
    state: WorkerState = WorkerState.HEALTHY
    slow_strikes: int = 0


@dataclasses.dataclass
class Event:
    t: float
    kind: str
    detail: str


class Coordinator:
    def __init__(self, num_workers: int, *, heartbeat_timeout_s: float = 30.0,
                 straggler_factor: float = 2.0, straggler_strikes: int = 3,
                 ckpt_cadence_steps: int = 100, min_cadence: int = 10,
                 stable_steps: int = 500,
                 dp_candidates: Optional[List[int]] = None):
        self.workers: Dict[int, Worker] = {
            i: Worker(i) for i in range(num_workers)}
        self.timeout = heartbeat_timeout_s
        self.straggler_factor = straggler_factor
        self.straggler_strikes = straggler_strikes
        self.nominal_cadence = ckpt_cadence_steps
        self.cadence = ckpt_cadence_steps
        self.min_cadence = min_cadence
        self.stable_steps = stable_steps
        self.dp_candidates = sorted(dp_candidates or
                                    [2 ** i for i in range(11)], reverse=True)
        self.phase = JobPhase.RUNNING
        self.step_times: List[float] = []
        self.events: List[Event] = []
        self.clean_steps_since_failure = 0
        self.restores = 0

    # ---------------------------------------------------------- signals
    def heartbeat(self, wid: int, t: float):
        w = self.workers[wid]
        w.last_heartbeat = t
        if w.state == WorkerState.FAILED:
            # rejoining worker: admitted at the next reshape point
            self.events.append(Event(t, "rejoin", f"worker {wid}"))
            w.state = WorkerState.HEALTHY
            w.slow_strikes = 0

    def report_step(self, wid: int, t: float, step_time_s: float):
        self.step_times.append(step_time_s)
        if len(self.step_times) > 64:
            self.step_times.pop(0)
        w = self.workers[wid]
        med = statistics.median(self.step_times)
        if step_time_s > self.straggler_factor * med and len(
                self.step_times) >= 8:
            w.slow_strikes += 1
            if w.state == WorkerState.HEALTHY:
                w.state = WorkerState.STRAGGLER
                self.events.append(Event(t, "straggler", f"worker {wid}"))
            if w.slow_strikes >= self.straggler_strikes:
                self._fail(w, t, "persistent straggler -> backup takeover")
        else:
            w.slow_strikes = 0
            if w.state == WorkerState.STRAGGLER:
                w.state = WorkerState.HEALTHY
        self.clean_steps_since_failure += 1
        if self.clean_steps_since_failure >= self.stable_steps:
            self.cadence = self.nominal_cadence

    # --------------------------------------------------------- failures
    def _fail(self, w: Worker, t: float, why: str):
        if w.state != WorkerState.FAILED:
            w.state = WorkerState.FAILED
            self.events.append(Event(t, "failure", f"worker {w.wid}: {why}"))
            self.phase = JobPhase.RESHAPING
            self.clean_steps_since_failure = 0
            self.cadence = max(self.min_cadence, self.cadence // 2)

    def check_health(self, t: float):
        for w in self.workers.values():
            if (w.state != WorkerState.FAILED
                    and t - w.last_heartbeat > self.timeout):
                self._fail(w, t, "heartbeat timeout")

    # ----------------------------------------------------------- policy
    def healthy_workers(self) -> List[int]:
        return [w.wid for w in self.workers.values()
                if w.state != WorkerState.FAILED]

    def plan_mesh(self, global_batch: int) -> Tuple[int, List[int]]:
        """Elastic scale: the widest dp degree the survivors support such
        that the global batch still divides.  Returns (dp, member ids)."""
        alive = self.healthy_workers()
        for dp in self.dp_candidates:
            if dp <= len(alive) and global_batch % dp == 0:
                return dp, alive[:dp]
        return 1, alive[:1]

    def should_checkpoint(self, step: int) -> bool:
        return step % max(self.cadence, 1) == 0

    def resume_plan(self, global_batch: int):
        """After RESHAPING: the restore directive for the training driver."""
        dp, members = self.plan_mesh(global_batch)
        self.phase = JobPhase.RUNNING
        self.restores += 1
        self.events.append(Event(0.0, "reshape",
                                 f"dp={dp} members={members[:8]}..."))
        return {"dp": dp, "members": members,
                "restore_latest_checkpoint": True}
