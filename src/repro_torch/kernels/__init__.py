"""Hand-written Hopper kernels of the port and their plain versions.

Each module holds one kernel's wrapper (CUDA tensors launch the kernel
built from ``csrc/``; CPU tensors run the plain torch version), the plain
version itself, and a ``launches`` counter that the wrapper bumps once per
kernel launch.  Importing builds nothing: ``nvcc`` runs on first use.
"""
from __future__ import annotations

from repro_torch.kernels import (attention, bfrt, dlv_scan, lp_batch,
                                 pricing, segstats, split_tree)

KERNELS = {"pricing": pricing, "bfrt_histogram": bfrt,
           "segment_stats": segstats, "dlv_scan": dlv_scan,
           "flash_attention": attention, "lp_batch": lp_batch,
           "split_tree_descent": split_tree}


def reset_launches() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in KERNELS.items()}
