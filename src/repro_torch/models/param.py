"""Parameter specs (port of ``repro.models.param``).

Every weight is declared as a ``ParamInfo(shape, axes, init)`` in a
nested-dict *spec*; the same spec gives the parameter count and the
initialised tensors.  The logical axes name how a weight is sharded:
``Model.axes()`` hands them to the sharding rules
(``repro_torch.distributed.sharding``), which map them onto mesh axes.

``init_params`` draws from one explicit ``torch.Generator``, leaf by leaf in
the reference's flatten order (sorted keys).  The rules are the
reference's -- normal(0, scale), zeros, ones, fan-in "scaled" normals
(scale ``1/sqrt(prod(shape[:-1]))`` of the stacked shape), and Mamba's
"a_log" (A uniform in [1, 16), stored as its log) -- drawn in float32 and
cast to the parameter dtype.  A leaf of more than
``DRAW_WHOLE_MAX`` elements is drawn one index of its leading (layers)
axis at a time into the cast result, so no whole-leaf float32 temporary
exists; its fan-in is still that of the stacked shape.  The numbers
differ from ``jax.random``'s; tests carry the reference's parameters
across with ``repro_torch.models.convert.from_jax_params``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

Axes = Tuple[Optional[str], ...]

# Leaves up to this many elements are drawn whole, in one ``randn``: every
# leaf of the dense archs (glm4-9b's largest holds 2.2e9), so their draws
# are what they were before large leaves were sliced.  Mixtral's stacked
# ``wi`` at 8 layers holds 6.4e9 (a 25.8 GB float32 draw beside 12.9 GB of
# bf16); sliced, the temporary is one layer's 3.2 GB.
DRAW_WHOLE_MAX = 2 ** 32


@dataclasses.dataclass(frozen=True)
class ParamInfo:
    shape: Tuple[int, ...]
    axes: Axes
    init: str = "normal"       # normal | zeros | ones | scaled | a_log
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
    if info.init == "a_log":           # Mamba's A in [1, 16), stored as log
        u = torch.rand(info.shape, generator=generator, dtype=torch.float32,
                       device=device)
        return u.mul_(15.0).add_(1.0).log_().to(dtype)
    if info.init not in ("normal", "scaled"):
        raise ValueError(f"init rule {info.init!r} is not ported")
    scale = info.scale
    if info.init == "scaled":          # fan-in scaled (output projections)
        fan_in = int(np.prod(info.shape[:-1])) or 1
        scale = 1.0 / math.sqrt(fan_in)
    if math.prod(info.shape) <= DRAW_WHOLE_MAX:
        v = torch.randn(info.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return v.mul_(scale).to(dtype)
    out = torch.empty(info.shape, dtype=dtype, device=device)
    for part in out:
        part.copy_(torch.randn(part.shape, generator=generator,
                               dtype=torch.float32, device=device).mul_(scale))
    return out


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
