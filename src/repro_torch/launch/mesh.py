"""Production mesh construction (port of ``repro.launch.mesh``).

Functions, not module constants, so that importing this module starts no
process group.  The shapes are the reference's, kept so that the records
compare cell for cell: a single pod is (data=16, model=16) = 256
devices; multi-pod adds a leading 'pod' axis (2 x 16 x 16 = 512).  On
H100 hosts of 8 GPUs a 16-wide model axis spans two nodes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes only, no process group: enough for the
    sharding rules' specs (``make_rules``), not for placing tensors."""
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.shape))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def make_abstract_mesh(shape, axes) -> AbstractMesh:
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} vs axes {tuple(axes)}")
    return AbstractMesh(tuple(int(s) for s in shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod",
    "data", "model") with ``multi_pod``, over the process group that is
    up (its world must have 256 or 512 ranks; the dry-run's is a fake
    one, on ``device="cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_local_mesh(data: int = 1, model: int = 1, device: str = "cuda"):
    """A small ("data", "model") mesh over the world that is up (tests,
    the card's one-rank world)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device, (data, model),
                            mesh_dim_names=("data", "model"))


# H100 80GB HBM3 (SXM, 700 W) datasheet figures for the roofline notes;
# none is measured.
PEAK_FLOPS_BF16 = 989e12       # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12               # bytes/s per card
NVLINK_BW = 450e9              # bytes/s each way per card (NVLink 4)
HBM_BYTES = 80e9               # bytes per card
