"""Checkpoints of the port (port of ``repro.checkpoint``): step-atomic,
in the reference's on-disk layout."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
