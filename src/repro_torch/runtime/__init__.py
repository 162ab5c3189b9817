"""Runtime support of the port (mirrors ``repro.runtime``): the race
harness ``racecheck``.  The coordinator and the fault injector are later
work (ROADMAP queue 1, items 12 and 7)."""
from repro_torch.runtime import racecheck

__all__ = ["racecheck"]
