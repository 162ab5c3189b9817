"""Logical-axis -> mesh-axis sharding rules with divisibility fallbacks
(port of ``repro.distributed.sharding``).

Strategy (the reference's, MaxText-style):
  * TP: the first logical axis in TP_PRIORITY whose dim is divisible by the
    ``model`` mesh axis gets sharded over it (one TP dim per param).
  * FSDP/ZeRO: the largest remaining dim divisible by the full
    data-parallel degree (pod*data) is sharded over those axes.  Tiny
    params (< 2^16 elements) stay replicated.
  * 'layers' dims are never sharded.

A dim that does not divide stays unsharded, so no placement is ever
uneven.

A placement spec is a :class:`P`, one entry per tensor dim: ``None``, a
mesh axis name, or a tuple of names (sharded major to minor).  DTensor is
the port's GSPMD: :meth:`ShardingRules.placements` maps a ``P`` to a
DTensor placement list, one entry per mesh dim -- ``Shard(i)`` on every
mesh dim named in entry ``i``, ``Replicate()`` elsewhere.  The mesh dims
are ordered ``pod, data, model``, so a tuple entry such as
``("pod", "data")`` shards its tensor dim pod-major, as the reference
does.

The rules read only a mesh's axis names and sizes: a real
``DeviceMesh`` or an :class:`repro_torch.launch.mesh.AbstractMesh` (names
and sizes, no process group) both serve; placing tensors needs the real
one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

# Logical axes eligible for tensor parallelism, in priority order.
TP_PRIORITY = (
    "vocab", "experts", "mlp", "heads", "ssm_inner", "kv_heads",
    "qlora", "kvlora", "ssm_state",
)
FSDP_MIN_SIZE = 1 << 16


class P(tuple):
    """A placement spec: one entry per tensor dim (``None``, an axis
    name or a tuple of names); the reference's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 \
            else f"P({self[0]!r})"


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an abstract mesh."""
    if hasattr(mesh, "axis_sizes"):
        return dict(mesh.axis_sizes)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh's dims must be named")
    return {n: int(mesh.size(i)) for i, n in enumerate(names)}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Any
    dp_axes: Tuple[str, ...]        # ("data",) or ("pod", "data")
    tp_axis: str = "model"
    # decode: shard per-token activations' embedding dim over dp (the
    # weights' FSDP dim) instead of their batch dim
    replicate_decode_activations: bool = False
    # sequence-parallel attention where the head count does not divide
    # the model axis: S over 'model' inside the attention block
    seq_parallel_attn: bool = False

    @property
    def sizes(self) -> Dict[str, int]:
        return axis_sizes(self.mesh)

    @property
    def dp_size(self) -> int:
        s = self.sizes
        return int(math.prod(s[a] for a in self.dp_axes))

    @property
    def tp_size(self) -> int:
        return int(self.sizes[self.tp_axis])

    # ------------------------------------------------------------ params
    def param_pspec(self, shape: Sequence[int],
                    axes: Sequence[Optional[str]]) -> P:
        entries: list = [None] * len(shape)
        tp = self.tp_size
        for name in TP_PRIORITY:                 # 1) tensor parallelism
            i = next((i for i, a in enumerate(axes)
                      if a == name and shape[i] % tp == 0
                      and shape[i] >= tp), None)
            if i is not None:
                entries[i] = self.tp_axis
                break
        if math.prod(shape) >= FSDP_MIN_SIZE:    # 2) FSDP, largest dim
            dp = self.dp_size
            for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
                if entries[i] is not None or axes[i] == "layers":
                    continue
                if shape[i] % dp == 0 and shape[i] >= dp:
                    entries[i] = self._dp_all()
                    break
        return P(*entries)

    # -------------------------------------------------------- activations
    def _dp_all(self):
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    def batch_pspec(self, batch_size: int, extra_dims: int = 1) -> P:
        """(B, ...) activation/input spec: B over dp when divisible."""
        return P(self._dp_entry(batch_size), *([None] * extra_dims))

    def _dp_entry(self, dim: int):
        if dim % self.dp_size == 0 and dim >= self.dp_size:
            return self._dp_all()
        # multi-pod, B divisible by data but not pod*data
        data = self.sizes.get("data")
        if "data" in self.dp_axes and dim % data == 0 and dim >= data:
            return "data"
        return None

    def cache_pspec(self, shape: Sequence[int], kind: str) -> P:
        """Decode-cache specs.

        kv:    (L, B, S, KV, hd)  -> B over dp, S over model
        mla:   (L, B, S, r)       -> B over dp, S over model
        state: (L, B, nh, N, hp)  -> B over dp, nh over model if divisible
        conv:  (L, B, ck, Ch)     -> B over dp, Ch over model if divisible
        """
        b = self._dp_entry(shape[1])
        tp = self.tp_size
        if kind in ("kv", "mla"):
            S = shape[2]
            s_entry = None
            if S % tp == 0:
                s_entry = self.tp_axis
                # B undivisible (long_500k's B = 1): spread S over dp too
                if b is None and S % (tp * self.dp_size) == 0:
                    s_entry = tuple(self.dp_axes) + (self.tp_axis,)
            return P(None, b, s_entry, *([None] * (len(shape) - 3)))
        if kind == "state":
            nh = shape[2]
            h_entry = self.tp_axis if nh % tp == 0 and nh >= tp else None
            return P(None, b, h_entry, *([None] * (len(shape) - 3)))
        if kind == "conv":
            c_entry = self.tp_axis if shape[-1] % tp == 0 else None
            return P(*([None, b] + [None] * (len(shape) - 3) + [c_entry]))
        raise ValueError(kind)

    # --------------------------------------------------------- placement
    def placements(self, pspec: Sequence) -> list:
        """The DTensor placements of ``pspec`` on this mesh, one entry a
        mesh dim: ``Shard(i)`` on every mesh dim that entry ``i`` names,
        ``Replicate()`` elsewhere.  A tuple entry's axes must come in the
        mesh's order (major to minor); an axis used twice raises.  A mesh
        dim of size 1 holds the whole tensor either way and is given
        ``Replicate()`` (DTensor's view rules refuse a shard on a dim of
        size 1 that a reshape merges)."""
        from torch.distributed.tensor import Replicate, Shard
        sizes = self.sizes
        names = list(sizes)
        out: list = [Replicate()] * len(names)
        for i, entry in enumerate(pspec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            pos = [names.index(a) for a in axes]
            if pos != sorted(pos):
                raise ValueError(f"{pspec}: entry {entry!r} is not in the "
                                 f"mesh's axis order {tuple(names)}")
            for j in pos:
                if out[j] != Replicate():
                    raise ValueError(f"{pspec}: axis {names[j]!r} is used "
                                     "twice")
                out[j] = Shard(i)
        return [Replicate() if sizes[n] == 1 else q
                for n, q in zip(names, out)]

    def place(self, t, pspec: Sequence):
        """``t`` (a tensor alike on every rank, or a DTensor on this
        mesh) as a DTensor on ``pspec``'s placements."""
        from torch.distributed.tensor import DTensor, Replicate
        pl = self.placements(pspec)
        if not isinstance(t, DTensor):
            # alike on every rank: Replicate -> Shard is a local slice
            t = DTensor.from_local(t, self.mesh,
                                   [Replicate()] * len(pl), run_check=False)
        elif t.device_mesh != self.mesh:
            raise ValueError("a DTensor on another mesh than the rules'")
        return t.redistribute(self.mesh, pl)

    def shard_params(self, model) -> Dict[str, str]:
        """Replace every registered parameter of ``model`` (a
        ``repro_torch.models.model.Model``) by an ``nn.Parameter`` holding
        a DTensor on its :meth:`param_pspec` (axes from the model's spec),
        ``requires_grad`` kept.  Returns {dotted name: spec} as
        :meth:`explain` words it."""
        from torch import nn
        axes = dict(model.axes())
        out = {}
        for name, p in list(model.named_parameters()):
            spec = self.param_pspec(tuple(p.shape), axes[name])
            mod = model.get_submodule(name.rpartition(".")[0])
            leaf = name.rpartition(".")[2]
            mod.register_parameter(leaf, nn.Parameter(
                self.place(p.detach(), spec),
                requires_grad=p.requires_grad))
            out[name] = f"{tuple(p.shape)} {axes[name]} -> {spec}"
        return out

    # ------------------------------------------------------------- report
    def explain(self, spec_leaves) -> Dict[str, str]:
        """name -> 'shape axes -> pspec' over (name, ParamInfo) pairs."""
        return {name: f"{info.shape} {info.axes} -> "
                      f"{self.param_pspec(info.shape, info.axes)}"
                for name, info in spec_leaves}


def local_extent(shape: Sequence[int], mesh, placements
                 ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(local shape, global offset) of this rank's shard of a tensor of
    global ``shape`` on ``placements`` (even shards only; host ints, no
    tensor op, so it holds under ``FakeTensorMode``)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    local, off = list(shape), [0] * len(shape)
    for j, q in enumerate(placements):       # major to minor
        if isinstance(q, Shard):
            n = mesh.size(j)
            if local[q.dim] % n:
                raise ValueError(f"dim {q.dim} of {tuple(shape)} does not "
                                 f"divide over mesh dim {j} ({n})")
            local[q.dim] //= n
            off[q.dim] += coord[j] * local[q.dim]
    return tuple(local), tuple(off)


def cache_kind(key: str) -> Optional[str]:
    """The ``cache_pspec`` kind of a decode-cache leaf by its key (None:
    the index)."""
    if key in ("k", "v", "xk", "xv"):
        return "kv"
    if key in ("c", "r"):
        return "mla"
    if key.startswith("state"):
        return "state"
    if key.startswith("conv"):
        return "conv"
    return None


def make_rules(mesh, **kw) -> ShardingRules:
    names = axis_sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in names)
    return ShardingRules(mesh=mesh, dp_axes=dp, **kw)
