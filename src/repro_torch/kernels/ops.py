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


def flash_attention_op(q, k, v, *, causal: bool = True, window: int = 0,
                       scale=None, prefix: int = 0):
    """q: (B, Sq, H, d); k: (B, Sk, KV, d); v: (B, Sk, KV, dv) -> (B, Sq,
    H, dv), scores scaled by ``scale`` (``d^-1/2`` when None), keys below
    ``prefix`` attended by every query (prefix-LM).

    The GQA entry: the kernel maps query head h to KV head h // (H // KV)
    in place, so nothing is expanded.  MLA's prefill passes d = 192, dv =
    128 and its own scale; cross-attention Sq != Sk (not causal).  The
    reference's ``block_q`` / ``block_k`` are TPU tile sizes; the CUDA
    kernel's tiles are fixed.
    """
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window, scale=scale,
                           prefix=prefix)


__all__ = ["flash_attention_op"]
