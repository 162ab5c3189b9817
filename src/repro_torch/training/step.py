"""The train step (port of ``repro.training.step``): the loss's gradient
(optionally over microbatches, accumulated in float32), optional int8
gradient compression with error feedback, then AdamW.

State is a plain dict: ``{"params": model.params, "opt": {"mu", "nu",
"step"[, "ef"]}}``.  Its parameters are the model's own tensors, which
``init_train_state`` turns trainable (``requires_grad_(True)``) and the
step updates in place, so the model's inference entries see every step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.models.model import Model
from repro_torch.models.param import leaves
from repro_torch.training.compression import compress_with_ef, ef_init
from repro_torch.training.optimizer import (OptHyper, adamw_init,
                                            adamw_update, tree_map)


def abstract_train_state(model: Model) -> Dict[str, Any]:
    """The state's shapes and dtypes as tensors on the ``meta`` device
    (nothing allocated)."""
    cfg = model.cfg
    pdt, odt = getattr(torch, cfg.param_dtype), getattr(torch, cfg.opt_dtype)
    params = tree_map(lambda i: torch.empty(i.shape, dtype=pdt,
                                            device="meta"), model.spec())
    like = lambda p: torch.empty(p.shape, dtype=odt, device="meta")
    return {"params": params,
            "opt": {"mu": tree_map(like, params),
                    "nu": tree_map(like, params),
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")}}


def init_train_state(model: Model,
                     generator: Optional[torch.Generator] = None,
                     compress: bool = False) -> Dict[str, Any]:
    """The train state of ``model``: its parameters (drawn from
    ``generator`` when one is given or the model has none yet) with
    gradients turned on, zero moments in ``cfg.opt_dtype`` and, with
    ``compress``, a zero float32 error-feedback residual."""
    if generator is not None or not model.params:
        model.init(generator)
    model.requires_grad_(True)
    params = model.params
    opt = adamw_init(params, model.cfg.opt_dtype)
    if compress:
        opt["ef"] = ef_init(params)
    return {"params": params, "opt": opt}


def _split(batch: Dict[str, Any], i: int, n: int) -> Dict[str, Any]:
    """Microbatch ``i`` of ``n``: rows i*B/n .. (i+1)*B/n of every entry."""
    out = {}
    for k, x in batch.items():
        m = x.shape[0] // n
        out[k] = x[i * m:(i + 1) * m]
    return out


def _named_tree(tree: Dict[str, Any], named: Dict[str, Any],
                prefix: str = "") -> Dict[str, Any]:
    """``tree``'s structure with each leaf replaced by ``named``'s entry
    under its dotted name."""
    return {k: _named_tree(v, named, f"{prefix}{k}.") if isinstance(v, dict)
            else named[prefix + k] for k, v in tree.items()}


def make_train_step(model: Model, hyper: Optional[OptHyper] = None,
                    microbatches: int = 1,
                    compress: bool = False) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    With ``microbatches > 1`` the batch is split on dim 0 and the
    gradients summed into float32 zeros, then divided by the count;
    the loss is the microbatches' mean and the other metrics the last
    microbatch's, as the reference's scan gives them.  ``compress=True``
    applies int8 gradient compression with error feedback
    (``training.compression``); the residual lives in
    ``state["opt"]["ef"]`` (``init_train_state(..., compress=True)``).
    Metrics add ``loss``, ``grad_norm`` and ``step`` (float32).
    """
    hyper = hyper or OptHyper()

    def grads_of(params, batch):
        names = [n for n, _ in leaves(params)]
        flat = [p for _, p in leaves(params)]

        def one(b):
            loss, metrics = model.loss_fn(b)
            gs = torch.autograd.grad(loss, flat, allow_unused=True)
            return loss.detach(), metrics, [
                torch.zeros_like(p) if g is None else g
                for p, g in zip(flat, gs)]

        if microbatches <= 1:
            loss, metrics, gs = one(batch)
        else:
            gs = [torch.zeros_like(p, dtype=torch.float32) for p in flat]
            loss = torch.zeros((), dtype=torch.float32, device=flat[0].device)
            for i in range(microbatches):
                l, metrics, g = one(_split(batch, i, microbatches))
                for acc, gi in zip(gs, g):
                    acc.add_(gi)
                loss = loss + l
                del g
            gs = [a.div_(microbatches) for a in gs]
            loss = loss / microbatches
        return loss, metrics, _named_tree(params, dict(zip(names, gs)))

    def train_step(state, batch):
        loss, metrics, grads = grads_of(state["params"], batch)
        opt_in = dict(state["opt"])
        if compress:
            grads, new_ef = compress_with_ef(grads, opt_in.pop("ef"))
        params, opt, gnorm = adamw_update(grads, opt_in, state["params"],
                                          hyper)
        if compress:
            opt["ef"] = new_ef
        metrics = dict(metrics)
        metrics.update(loss=loss, grad_norm=gnorm,
                       step=opt["step"].float())
        return {"params": params, "opt": opt}, metrics

    return train_step
