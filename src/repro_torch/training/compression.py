"""Gradient compression with error feedback (port of
``repro.training.compression``).

int8 per-tensor-scaled quantisation of each gradient before the
optimizer: what reaches AdamW is exactly what a compressed allreduce
would deliver, and the quantisation residual is carried in the optimizer
state (``opt["ef"]``, float32) and added back the next step, which keeps
SGD/Adam convergence unbiased (Seide et al.; Karimireddy et al.).
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.training.optimizer import tree_map


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = g.abs().max() + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_init(params: Dict[str, Any]) -> Dict[str, Any]:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


@torch.no_grad()
def compress_with_ef(grads, residual):
    """Returns (dequantised grads in the gradients' dtypes, new
    residual)."""
    def one(g, r):
        g32 = g.float() + r
        deq = _dequantize(*_quantize(g32))
        return deq.to(g.dtype), g32 - deq
    pairs = tree_map(one, grads, residual)
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)


def compression_ratio() -> float:
    """Wire bytes ratio vs a float32 allreduce (int8 payload + f32
    scale)."""
    return 4.0
