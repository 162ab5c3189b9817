"""AdamW with global-norm clipping (port of ``repro.training.optimizer``).

Trees are the model's nested dicts of tensors (``Model.params``).  Moments
are stored in ``cfg.opt_dtype`` (float32 by default; bf16 for the
398B/671B MoEs); every update runs in float32 tensors on the parameters'
device.  ``step`` is an int32 0-d tensor.  The port applies the update in
place, under ``torch.no_grad()``, to the parameters, the moments and the
step (the reference returns new trees): the state passed in is the state
returned.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict

import torch

from repro_torch.models.param import leaves


@dataclasses.dataclass(frozen=True)
class OptHyper:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def tree_map(fn: Callable, tree: Dict[str, Any], *rest: Dict[str, Any]
             ) -> Dict[str, Any]:
    """``fn`` over the leaves of nested dicts of one structure."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def schedule(h: OptHyper, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step``: linear warmup over ``warmup_steps``,
    then a cosine from ``lr`` down to ``min_lr_frac * lr`` at
    ``total_steps`` (float32)."""
    step = step.float()
    warm = step / max(h.warmup_steps, 1)
    decay_t = ((step - h.warmup_steps)
               / max(h.total_steps - h.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = h.min_lr_frac + (1 - h.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * decay_t))
    return h.lr * torch.where(step < h.warmup_steps, warm, cos)


def adamw_init(params: Dict[str, Any], opt_dtype: str) -> Dict[str, Any]:
    dt = getattr(torch, opt_dtype)
    zeros = lambda p: torch.zeros_like(p, dtype=dt)   # a DTensor's too
    dev = next(t for _, t in leaves(params)).device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Dict[str, Any]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, the leaves
    summed in the reference's (sorted-key) order."""
    sq = None
    for _, g in leaves(tree):
        s = g.float().square().sum()
        sq = s if sq is None else sq + s
    return sq.sqrt()


@torch.no_grad()
def adamw_update(grads, opt_state, params, h: OptHyper):
    """One AdamW step: (params, opt_state, the gradients' global norm
    before clipping).  Gradients are scaled by min(1, clip_norm / norm);
    weight decay is decoupled (added to the Adam direction)."""
    step = opt_state["step"].add_(1)
    lr = schedule(h, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(h.clip_norm / gnorm.clamp_min(1e-9), max=1.0)
    t = step.float()
    bc1 = 1 - h.b1 ** t
    bc2 = 1 - h.b2 ** t
    named_g = dict(leaves(grads))
    named_mu = dict(leaves(opt_state["mu"]))
    named_nu = dict(leaves(opt_state["nu"]))
    for name, p in leaves(params):
        mu, nu = named_mu[name], named_nu[name]
        g32 = named_g[name].float() * scale
        mu32 = h.b1 * mu.float() + (1 - h.b1) * g32
        nu32 = h.b2 * nu.float() + (1 - h.b2) * g32.square()
        upd = (mu32 / bc1) / ((nu32 / bc2).sqrt() + h.eps)
        upd = upd + h.weight_decay * p.float()
        p.copy_(p.float() - lr * upd)
        mu.copy_(mu32)
        nu.copy_(nu32)
    return params, {"mu": opt_state["mu"], "nu": opt_state["nu"],
                    "step": step}, gnorm
