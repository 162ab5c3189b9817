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

The reference's ``constrain`` sharding hints are no-ops on one card and
are left out; with no sharding rules its data-parallel size is 1.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
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
    """xf: (G, T, D) -> gates (G, T, K) float32, idx (G, T, K), aux loss.
    The router product runs in the activation dtype, then goes to
    float32, as in the reference."""
    logits = (xf @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k(probs, cfg.num_experts_per_tok)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balancing auxiliary loss (Switch-style)
    E = cfg.num_experts
    me = probs.mean(dim=(0, 1))                               # mean router prob
    ce = F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1))   # top-1 load
    return gate, idx, E * (me * ce).sum()


def tokens_per_group(T: int, group_size: int = 4096) -> int:
    """Tokens a group (``moe.py:72-80``).  With a data-parallel size of 1
    both of the reference's branches give min(group_size, T), shrunk until
    it divides T."""
    g = max(1, min(group_size, T))
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


def route(p, cfg: ArchConfig, x: torch.Tensor,
          group_size: int = 4096) -> Routing:
    """Routing and capacity bookkeeping of ``apply_moe`` for x (B, S, D)."""
    B, S, D = x.shape
    K = cfg.num_experts_per_tok
    T = B * S
    g = tokens_per_group(T, group_size)
    G = T // g
    gate, idx, aux = _route(p, cfg, x.reshape(G, g, D))
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
    return Routing(g, C, gate, idx, pos, pos < C, aux)


def apply_moe(p, cfg: ArchConfig, x: torch.Tensor,
              group_size: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (routed + shared expert output (B, S, D), aux)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    r = route(p, cfg, x, group_size)
    g, C = r.g, r.C
    G = B * S // g
    xf = x.reshape(G, g, D)
    dev = x.device

    # dispatch: the source token of each (expert, slot), g (a zero row)
    # where the slot is empty; a dropped copy goes to the sentinel slot E*C
    slot = torch.where(r.keep, r.idx * C + r.pos, E * C)
    tok = torch.arange(g, device=dev).view(1, g, 1).expand(G, g, K)
    disp = torch.full((G, E * C + 1), g, dtype=torch.long, device=dev)
    disp.scatter_(1, slot.reshape(G, -1),
                  torch.where(r.keep, tok, g).reshape(G, -1))
    disp = disp[:, :E * C].view(G, E, C).transpose(0, 1)     # (E, G, C)
    xpad = torch.cat([xf, xf.new_zeros(G, 1, D)], dim=1)
    gi = torch.arange(G, device=dev)
    xe = xpad[gi.view(1, G, 1), disp].reshape(E, G * C, D)

    # expert FFN (SwiGLU) in the activation dtype, one product per expert
    h = torch.bmm(xe, p["wi"])
    gt = torch.bmm(xe, p["wg"])
    y = torch.bmm(F.silu(h) * gt, p["wo"]).view(E, G, C, D)

    # combine: each token's kept slots, gate-weighted in the activation
    # dtype, added in k order
    gate = r.gate.to(x.dtype)
    pos = r.pos.clamp(max=C - 1)
    gi = gi.view(G, 1)
    out = torch.zeros_like(xf)
    for k in range(K):
        rows = y[r.idx[..., k], gi, pos[..., k]] * gate[..., k, None]
        out = out + torch.where(r.keep[..., k, None], rows, 0)

    if "shared" in p:
        out = out + apply_mlp(p["shared"], xf, "silu")
    return out.reshape(B, S, D), r.aux


def ref_moe(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Dense no-drop oracle: every expert applied to every token, masked;
    combined in float32."""
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(1, T, D)
    gate, idx, _ = _route(p, cfg, xf)
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
