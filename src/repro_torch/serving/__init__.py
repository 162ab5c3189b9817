from repro_torch.serving.engine import Generation, ServingEngine, TickStats
from repro_torch.serving.scheduler import PackageScheduler, Request

__all__ = ["PackageScheduler", "Request", "ServingEngine", "Generation",
           "TickStats"]
