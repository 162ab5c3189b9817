"""Runtime support of the port (mirrors ``repro.runtime``): the fault
injector ``faults`` and the race harness ``racecheck``.  The coordinator
is later work (ROADMAP queue 1, item 12)."""
from repro_torch.runtime import faults
from repro_torch.runtime import racecheck

__all__ = ["faults", "racecheck"]
