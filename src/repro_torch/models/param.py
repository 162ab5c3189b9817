"""Parameter specs (port of ``repro.models.param``).

Every weight is declared as a ``ParamInfo(shape, axes, init)`` in a
nested-dict *spec*; the same spec gives the parameter count and the
initialised tensors.  The logical axes are kept for parity with the
reference's specs (they name the sharding of a weight); the single-card
port does not read them.

``init_params`` draws from one explicit ``torch.Generator``, leaf by leaf in
the reference's flatten order (sorted keys).  The rules are the
reference's -- normal(0, scale), zeros, ones, and fan-in "scaled" normals
(scale ``1/sqrt(prod(shape[:-1]))`` of the stacked shape) -- drawn in
float32 and cast to the parameter dtype.  The numbers differ from
``jax.random``'s; tests carry the reference's parameters across with
``repro_torch.models.convert.from_jax_params``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

Axes = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ParamInfo:
    shape: Tuple[int, ...]
    axes: Axes
    init: str = "normal"       # normal | zeros | ones | scaled
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def stacked(spec: Dict[str, Any], num: int) -> Dict[str, Any]:
    """Prepend a 'layers' dimension to every ParamInfo in a spec."""
    out = {}
    for k, v in spec.items():
        if isinstance(v, ParamInfo):
            out[k] = ParamInfo((num,) + v.shape, ("layers",) + v.axes,
                               v.init, v.scale)
        else:
            out[k] = stacked(v, num)
    return out


def leaves(tree: Dict[str, Any], prefix: str = "") -> Iterator[tuple]:
    """(dotted name, leaf) pairs in sorted-key order (JAX's flatten order)."""
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from leaves(v, name + ".")
        else:
            yield name, v


def param_count(spec: Dict[str, Any]) -> int:
    return sum(int(np.prod(i.shape)) for _, i in leaves(spec))


def _init_one(info: ParamInfo, generator: torch.Generator, dtype,
              device) -> torch.Tensor:
    if info.init == "zeros":
        return torch.zeros(info.shape, dtype=dtype, device=device)
    if info.init == "ones":
        return torch.ones(info.shape, dtype=dtype, device=device)
    if info.init not in ("normal", "scaled"):
        raise ValueError(f"init rule {info.init!r} is not ported")
    scale = info.scale
    if info.init == "scaled":          # fan-in scaled (output projections)
        fan_in = int(np.prod(info.shape[:-1])) or 1
        scale = 1.0 / math.sqrt(fan_in)
    v = torch.randn(info.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return v.mul_(scale).to(dtype)


def init_params(spec: Dict[str, Any], generator: torch.Generator, dtype,
                device) -> Dict[str, Any]:
    """Nested dict of initialised tensors mirroring ``spec``."""
    out: Dict[str, Any] = {}
    for name, info in leaves(spec):
        node = out
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = _init_one(info, generator, dtype, device)
    return out
