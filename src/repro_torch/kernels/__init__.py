"""Hand-written Hopper kernels of the port and their plain versions.

Each module holds one kernel's wrapper (CUDA tensors launch the kernel
built from ``csrc/``; CPU tensors run the plain torch version), the plain
version itself, and a ``launches`` counter that the wrapper bumps once per
kernel launch (``dlv_scan.seed_launches`` for the seed scan, which shares
its module with the DLV scan; ``attention.bwd_launches`` for the flash
backward, once per call of its three kernels, and ``bwd_tc_launches``
for those calls that took its tensor-core route).  Importing builds
nothing: ``nvcc`` runs on first use.
"""
from __future__ import annotations

from repro_torch.kernels import (attention, bfrt, dlv_scan, lp_batch,
                                 pricing, segstats, split_tree)

KERNELS = {"pricing": pricing, "bfrt_histogram": bfrt,
           "segment_stats": segstats, "dlv_scan": dlv_scan,
           "dlv_scan_seed": dlv_scan, "flash_attention": attention,
           "lp_batch": lp_batch, "split_tree_descent": split_tree,
           "flash_attention_bwd": attention,
           "flash_attention_bwd_tc": attention}
# a kernel's counter in its module, where it is not ``launches``
COUNTER = {"dlv_scan_seed": "seed_launches",
           "flash_attention_bwd": "bwd_launches",
           "flash_attention_bwd_tc": "bwd_tc_launches"}


def reset_launches() -> None:
    for name, mod in KERNELS.items():
        setattr(mod, COUNTER.get(name, "launches"), 0)


def launch_counts() -> dict:
    return {name: getattr(mod, COUNTER.get(name, "launches"))
            for name, mod in KERNELS.items()}
