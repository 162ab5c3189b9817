"""Carry a parameter tree (or a train state) of the JAX reference into the
port.

The port keeps the reference's names and layouts (``decoder.layers.attn.wq``
is (L, d, H, hd), ``embed.embedding`` is (V, d), ...), so a leaf moves
across as it is, with no transpose.  The tree's leaves are numpy arrays
(``np.asarray`` of the reference's arrays): float32, or bfloat16 as
``ml_dtypes`` gives it, which is read bit for bit.  Nothing here imports
JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import Model


def _tensor(a) -> torch.Tensor:
    a = np.array(a)                       # a writable, contiguous copy
    if a.dtype.name == "bfloat16":        # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _convert(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _convert(v) if isinstance(v, dict) else _tensor(v)
            for k, v in tree.items()}


def from_jax_params(tree: Dict[str, Any], cfg: ArchConfig,
                    device="cuda") -> Model:
    """A ``Model`` of ``cfg`` on ``device`` holding the reference's
    parameters ``tree`` (cast to ``cfg.param_dtype``)."""
    return Model(cfg, device=device).load_params(_convert(tree))


def from_jax_train_state(state: Dict[str, Any], cfg: ArchConfig,
                         device="cuda") -> Tuple[Model, Dict[str, Any]]:
    """The reference's train state ``{"params", "opt": {"mu", "nu", "step"
    [, "ef"]}}`` (numpy leaves) as (a ``Model`` holding its parameters,
    with gradients on, and the port's state over that model, as
    ``training.step.init_train_state`` makes it): moments in
    ``cfg.opt_dtype``, the error-feedback residual in float32, ``step`` an
    int32 0-d tensor."""
    model = from_jax_params(state["params"], cfg, device=device)
    model.requires_grad_(True)
    opt_in = state["opt"]

    def tree(t, dtype):
        return {k: tree(v, dtype) if isinstance(v, dict) else
                _tensor(v).to(device=model.device, dtype=dtype)
                for k, v in t.items()}

    mdt = getattr(torch, cfg.opt_dtype)
    opt = {"mu": tree(opt_in["mu"], mdt), "nu": tree(opt_in["nu"], mdt),
           "step": torch.tensor(int(np.asarray(opt_in["step"])),
                                dtype=torch.int32, device=model.device)}
    if "ef" in opt_in:
        opt["ef"] = tree(opt_in["ef"], torch.float32)
    return model, {"params": model.params, "opt": opt}
