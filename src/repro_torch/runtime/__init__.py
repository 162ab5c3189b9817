"""Runtime support of the port (mirrors ``repro.runtime``): the training
fleet's ``Coordinator`` (heartbeats, stragglers, elastic mesh plans and the
adaptive checkpoint cadence; ROADMAP queue 1, item 10f(ii)), the fault
injector ``faults`` and the race harness ``racecheck``."""
from repro_torch.runtime.coordinator import Coordinator, WorkerState
from repro_torch.runtime import faults
from repro_torch.runtime import racecheck

__all__ = ["Coordinator", "WorkerState", "faults", "racecheck"]
