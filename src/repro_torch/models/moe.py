"""Mixture of experts with group-local capacity dispatch (port of
``repro.models.moe``, GShard/MaxText "dropping" style).

Tokens are split into groups; routing, capacity bookkeeping, dispatch
and combine are local to a group.  Top-k gates are renormalised, copies
are ranked k-major so first choices win capacity, and a copy past its
expert's capacity C is dropped: it adds nothing, so a token whose copies
all drop gets the shared expert's output alone (zero in a pure-routed
layer).  ``ref_moe`` is the exact no-drop oracle (every expert on every
token, masked): the layer's plain reference for the tests and the card
check; no main path calls it.

Where the port's ops differ from the reference's, and why the result
does not:

- top-k is a stable descending sort cut to K, so equal probabilities
  come lower expert first, as ``jax.lax.top_k`` orders them
  (``torch.topk`` promises no order at ties, and the order decides both
  the capacity priority and ``aux``'s top-1 load);
- the reference scatters with ``mode="drop"``; torch's index ops have no
  such mode, so a dropped copy is dispatched into a sentinel slot that is
  cut off and combined as an explicit zero;
- the combine gathers each token's K slots and adds them to a zero row in
  k order (first choice first), each add rounded in the activation
  dtype: a fixed order, so a rerun on the card is bit-identical for any K
  (``index_add_`` adds with atomics).  The reference scatter-adds the same
  gate-weighted rows; at K = 2 either order gives the same bits
  (0 + a + b = 0 + b + a).

Under sharding rules (``repro_torch.distributed.context``) the groups
are sized by the rules' data-parallel size and pinned over the
data-parallel axes as in the reference; routing, dispatch and combine
are group-local, so they run on each rank's groups through ``local_map``
(a DTensor takes no sort, gather or scatter there), and the expert
products run on DTensors, the dispatched tokens pinned experts over the
model axis (or, under ``replicate_decode_activations``, the embedding
dim over dp) as the reference pins them.  With no rules active the
data-parallel size is 1 and every hint returns its input.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.context import (constrain, current_rules,
                                             spec_of, use_rules)
from repro_torch.distributed.ops import reshape_rows
from repro_torch.distributed.sharding import P as P_
from repro_torch.models.layers import apply_mlp, mlp_spec
from repro_torch.models.param import ParamInfo


def moe_spec(cfg: ArchConfig) -> Dict:
    d, E, F_ = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    spec = {
        "router": ParamInfo((d, E), ("embed", "experts")),
        "wi": ParamInfo((E, d, F_), ("experts", "embed", "mlp")),
        "wg": ParamInfo((E, d, F_), ("experts", "embed", "mlp")),
        "wo": ParamInfo((E, F_, d), ("experts", "mlp", "embed"),
                        init="scaled"),
    }
    if cfg.num_shared_experts:
        spec["shared"] = mlp_spec(cfg, cfg.moe_d_ff * cfg.num_shared_experts)
    return spec


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest along the last axis, largest first and the lower
    index first among equals (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p, cfg: ArchConfig, xf: torch.Tensor):
    """xf: (G, T, D) -> gates (G, T, K) float32, idx (G, T, K), and the
    aux loss's mean router probability and mean top-1 load (E,).
    The router product runs in the activation dtype, then goes to
    float32, as in the reference."""
    logits = (xf @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k(probs, cfg.num_experts_per_tok)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balancing auxiliary loss (Switch-style): its two means
    me = probs.mean(dim=(0, 1))                               # mean router prob
    ce = F.one_hot(idx[..., 0], cfg.num_experts).float().mean(
        dim=(0, 1))                                           # top-1 load
    return gate, idx, me, ce


def tokens_per_group(T: int, group_size: int = 4096, dp: int = 1) -> int:
    """Tokens a group (the reference's ``moe.py:71-80``): where each of
    the ``dp`` data-parallel shards holds 1,024 tokens or more, groups
    align with the shards (min(group_size, T // dp)); else one group of
    min(group_size, T); then shrunk until it divides T."""
    g = min(group_size, T // dp) if T // dp >= 1024 else min(group_size, T)
    g = max(1, g)
    while T % g:
        g -= 1
    return g


def capacity(cfg: ArchConfig, g: int) -> int:
    """Slots an expert in a group of ``g`` tokens: the reference's float
    expression, in its order."""
    C = max(1, int(math.ceil(g * cfg.num_experts_per_tok / cfg.num_experts
                             * cfg.capacity_factor)))
    return min(C, g)


@dataclasses.dataclass
class Routing:
    """The dispatch plan of one ``apply_moe`` call over G groups of g
    tokens: gates (G, g, K) float32, experts ``idx`` (G, g, K), each
    copy's position in its expert's queue ``pos`` (G, g, K) and whether it
    fits the capacity ``keep`` (G, g, K); C slots an expert; aux loss."""
    g: int
    C: int
    gate: torch.Tensor
    idx: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    aux: torch.Tensor
    me: torch.Tensor = None        # the aux loss's mean router prob (E,)
    ce: torch.Tensor = None        # and mean top-1 load (E,)


def route(p, cfg: ArchConfig, x: torch.Tensor,
          group_size: int = 4096) -> Routing:
    """Routing and capacity bookkeeping of ``apply_moe`` for x (B, S, D)."""
    B, S, D = x.shape
    g, G = _groups(x, group_size)
    return _route_groups(p, cfg, x.reshape(G, g, D))


def _groups(x: torch.Tensor, group_size: int) -> Tuple[int, int]:
    """(tokens a group, groups) of x (B, S, D), by the active rules'
    data-parallel size (1 without rules)."""
    B, S, _ = x.shape
    rules = current_rules()
    T = B * S
    g = tokens_per_group(T, group_size,
                         rules.dp_size if rules is not None else 1)
    return g, T // g


def _route_groups(p, cfg: ArchConfig, xf: torch.Tensor) -> Routing:
    """Routing and capacity bookkeeping of xf (G, g, D)."""
    G, g, _ = xf.shape
    K = cfg.num_experts_per_tok
    gate, idx, me, ce = _route(p, cfg, xf)
    aux = cfg.num_experts * (me * ce).sum()
    C = capacity(cfg, g)
    # position of every (token, k) copy within its expert, k-major so first
    # choices win capacity (GShard priority): the copies before it in that
    # order that went to the same expert.  The one-hot is laid out (G, E,
    # K*g), so the scan runs along the innermost axis
    idx_km = idx.transpose(1, 2).reshape(G, K * g)
    experts = torch.arange(cfg.num_experts, device=idx.device)
    oh = idx_km[:, None, :] == experts[:, None]               # (G, E, K*g)
    pos_km = oh.cumsum(-1).gather(1, idx_km[:, None, :])[:, 0] - 1
    pos = pos_km.view(G, K, g).transpose(1, 2)
    return Routing(g, C, gate, idx, pos, pos < C, aux, me, ce)


def apply_moe(p, cfg: ArchConfig, x: torch.Tensor,
              group_size: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (routed + shared expert output (B, S, D), aux)."""
    B, S, D = x.shape
    g, G = _groups(x, group_size)
    if current_rules() is None:
        xf = x.reshape(G, g, D)
        out, aux = _moe_groups(p, cfg, xf)
    else:
        x = constrain(x, ("dp", None, None))
        xf = constrain(reshape_rows(x, (G, g, D)), ("dp", None, None))
        out, aux = _moe_sharded(p, cfg, xf)
    if "shared" in p:
        out = out + apply_mlp(p["shared"], xf, "silu")
    return reshape_rows(out, (B, S, D)), aux


def _dispatch(r: Routing, cfg: ArchConfig, xf: torch.Tensor
              ) -> torch.Tensor:
    """The dispatched tokens (E, G, C, D): the source token of each
    (expert, slot), a zero row where the slot is empty; a dropped copy
    goes to the sentinel slot E*C."""
    G, g, D = xf.shape
    E, K, C = cfg.num_experts, cfg.num_experts_per_tok, r.C
    dev = xf.device
    slot = torch.where(r.keep, r.idx * C + r.pos, E * C)
    tok = torch.arange(g, device=dev).view(1, g, 1).expand(G, g, K)
    disp = torch.full((G, E * C + 1), g, dtype=torch.long, device=dev)
    disp.scatter_(1, slot.reshape(G, -1),
                  torch.where(r.keep, tok, g).reshape(G, -1))
    disp = disp[:, :E * C].view(G, E, C).transpose(0, 1)     # (E, G, C)
    xpad = torch.cat([xf, xf.new_zeros(G, 1, D)], dim=1)
    gi = torch.arange(G, device=dev)
    return xpad[gi.view(1, G, 1), disp]


def _experts(p, xe: torch.Tensor) -> torch.Tensor:
    """The expert FFN (SwiGLU) of xe (E, G, C, D) in the activation
    dtype, one product per expert."""
    E, G, C, D = xe.shape
    xe = xe.reshape(E, G * C, D)
    h = torch.bmm(xe, p["wi"])
    gt = torch.bmm(xe, p["wg"])
    return torch.bmm(F.silu(h) * gt, p["wo"]).view(E, G, C, D)


def _combine(r: Routing, y: torch.Tensor, dtype) -> torch.Tensor:
    """Each token's kept slots of y (E, G, C, D), gate-weighted in the
    activation dtype, added in k order: (G, g, D)."""
    G, C = y.shape[1], r.C
    gate = r.gate.to(dtype)
    pos = r.pos.clamp(max=C - 1)
    gi = torch.arange(G, device=y.device).view(G, 1)
    out = torch.zeros(r.idx.shape[:2] + y.shape[-1:], dtype=dtype,
                      device=y.device)
    for k in range(r.idx.shape[-1]):
        rows = y[r.idx[..., k], gi, pos[..., k]] * gate[..., k, None]
        out = out + torch.where(r.keep[..., k, None], rows, 0)
    return out


def _moe_groups(p, cfg: ArchConfig, xf: torch.Tensor):
    """The routed experts of xf (G, g, D) on plain tensors: (out, aux)."""
    r = _route_groups(p, cfg, xf)
    y = _experts(p, _dispatch(r, cfg, xf))
    return _combine(r, y, xf.dtype), r.aux


def _moe_sharded(p, cfg: ArchConfig, xf: torch.Tensor):
    """The routed experts under sharding rules.  Routing and dispatch
    run group-local on each rank's groups (``local_map``, G over dp where
    it divides); the dispatched tokens (E, G, C, D) are pinned (tp, dp,
    None, None) -- the reference's (dp, tp, None, None) in its (G, E, C,
    D) layout -- or (tp, None, None, dp) under
    ``replicate_decode_activations``; the expert products run on
    DTensors; the combine is group-local again, over every expert."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    rules = current_rules()
    mesh = rules.mesh
    gspec = spec_of(xf, ("dp", None, None))
    pl_g = rules.placements(gspec)                 # (G, g, *) over dp
    pl_e = rules.placements(P_(None, gspec[0], None, None))  # (E, G, C, D)
    rep = [Replicate()] * mesh.ndim
    # the dp shards hold different groups: a mean over the groups is the
    # sum of the shards' means over their count, and the router's
    # gradient is the sum of the shards'
    split = [q != Replicate() for q in pl_g]
    n = 1
    for j, sp in enumerate(split):
        n *= mesh.size(j) if sp else 1
    pl_sum = [Partial() if sp else Replicate() for sp in split]
    keys = ("gate", "idx", "pos", "keep")

    def route_local(xf_, router_):
        with use_rules(None):
            r = _route_groups({"router": router_}, cfg, xf_)
            xe = _dispatch(r, cfg, xf_)
        return (xe,) + tuple(getattr(r, k) for k in keys) + (r.me / n,
                                                            r.ce / n)

    xf = rules.place(xf, gspec)
    router = rules.place(p["router"], P_(None, None))
    outs = local_map(route_local,
                     out_placements=(pl_e,) + (pl_g,) * 4 + (pl_sum,) * 2,
                     in_placements=(pl_g, rep),
                     in_grad_placements=(pl_g, pl_sum),
                     device_mesh=mesh)(xf, router)
    xe, routed = outs[0], outs[1:5]
    me, ce = (t.redistribute(mesh, rep) for t in outs[5:])
    aux = cfg.num_experts * (me * ce).sum()
    g = xf.shape[1]
    C = capacity(cfg, g)
    if rules.replicate_decode_activations:
        espec = ("tp", None, None, "dp")
    else:
        espec = ("tp", "dp", None, None)
    xe = constrain(xe, espec)
    y = constrain(_experts(p, xe), espec)
    y = rules.place(y, P_(None, gspec[0], None, None))

    def combine_local(y_, gate, idx, pos, keep):
        with use_rules(None):
            r = Routing(g, C, gate, idx, pos, keep, None)
            return _combine(r, y_, xf.dtype)

    out = local_map(combine_local, out_placements=pl_g,
                    in_placements=(pl_e,) + (pl_g,) * 4,
                    device_mesh=mesh)(y, *routed)
    if rules.replicate_decode_activations:
        out = constrain(out, (None, None, "dp"))
    else:
        out = constrain(out, ("dp", None, None))
    return out, aux


def ref_moe(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Dense no-drop oracle: every expert applied to every token, masked;
    combined in float32."""
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(1, T, D)
    gate, idx, _, _ = _route(p, cfg, xf)
    gate, idx = gate[0], idx[0]                               # (T, K)
    x0 = xf[0]
    ye = torch.stack([
        (F.silu(x0 @ p["wi"][e]) * (x0 @ p["wg"][e])) @ p["wo"][e]
        for e in range(cfg.num_experts)])                      # (E, T, D)
    w = torch.zeros((cfg.num_experts, T), dtype=torch.float32,
                    device=x.device)
    w.scatter_add_(0, idx.T, gate.T)      # a token's K experts are distinct
    out = torch.einsum("etd,et->td", ye.float(), w)
    if "shared" in p:
        out = out + apply_mlp(p["shared"], x0, "silu").float()
    return out.reshape(B, S, D).to(x.dtype)
