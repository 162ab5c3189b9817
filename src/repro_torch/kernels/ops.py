"""Public entries of the kernels (port of ``repro.kernels.ops``).

The reference's wrappers pick Pallas interpret mode off the TPU; here the
device of the tensors picks: a CUDA tensor launches the hand-written
kernel, a CPU tensor runs its plain version.  Only the attention entry
has a counterpart so far; the LP and partitioning kernels are called
through their own modules (``kernels.pricing``, ``kernels.bfrt``,
``kernels.segstats``).
"""
from __future__ import annotations

from repro_torch.kernels.attention import flash_attention


def flash_attention_op(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, d); k/v: (B, S, KV, d) -> (B, S, H, d).

    The GQA entry: the kernel maps query head h to KV head h // (H // KV)
    in place, so nothing is expanded.  The reference's ``block_q`` /
    ``block_k`` are TPU tile sizes; the CUDA kernel's tiles are fixed.
    """
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window)


__all__ = ["flash_attention_op"]
