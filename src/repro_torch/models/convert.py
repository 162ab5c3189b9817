"""Carry a parameter tree of the JAX reference into the port.

The port keeps the reference's names and layouts (``decoder.layers.attn.wq``
is (L, d, H, hd), ``embed.embedding`` is (V, d), ...), so a leaf moves
across as it is, with no transpose.  The tree's leaves are numpy arrays
(``np.asarray`` of the reference's arrays): float32, or bfloat16 as
``ml_dtypes`` gives it, which is read bit for bit.  Nothing here imports
JAX.
"""
from __future__ import annotations

from typing import Any, Dict

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
