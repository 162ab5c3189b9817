"""Mamba2 SSD (state-space duality) layer (port of ``repro.models.ssm``):
the chunked scan over a whole sequence and the one-token decode step, per
arXiv:2405.21060.

Shapes: d_inner = expand * d_model, heads nh = d_inner / head_dim (hp),
state size N.  B/C are shared across heads (MQA-like); dt and A are per
head; a depthwise causal conv (width ssm_conv) runs over [x, B, C].

The reference computes every product here outside Pallas, so the port
keeps them as torch products.  Its ``lax.scan`` over the S/Q chunks is a
Python loop of two ops a chunk, in the reference's order: the state
*before* a chunk is emitted, then ``h * decay + S_chunk``.  The quadratic
intra-chunk tensors (decay, L, W) are built once, in place (out of
place, with the same arithmetic, when autograd records: it keeps exp's
output), in the (B, nC, nh, Q, Q) layout that the batched products take;
the reference's ``(B, nC, Q, Q, nh)`` einsums contract the same sums.
Decode writes both caches in place (the reference returns new arrays):
the state (B, nh, N, hp) in float32 and the conv window (B, ck-1,
d_inner + 2N) in the parameter dtype.  Under sharding rules the scan
runs on each rank's rows and heads through ``local_map`` (B over dp,
heads over the model axis, as the reference pins its initial state),
and a decode step reads its state shard by shard.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.context import current_rules, use_rules
from repro_torch.distributed.sharding import P
from repro_torch.distributed.ops import is_dtensor, matmul
from repro_torch.models.param import ParamInfo


def ssm_spec(cfg: ArchConfig) -> Dict:
    d, di, N, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    ck = cfg.ssm_conv
    return {
        "wz": ParamInfo((d, di), ("embed", "ssm_inner")),
        "wx": ParamInfo((d, di), ("embed", "ssm_inner")),
        "wB": ParamInfo((d, N), ("embed", "ssm_state")),
        "wC": ParamInfo((d, N), ("embed", "ssm_state")),
        "wdt": ParamInfo((d, nh), ("embed", "ssm_heads")),
        "dt_bias": ParamInfo((nh,), ("ssm_heads",), init="zeros"),
        "conv": ParamInfo((ck, di + 2 * N), ("conv", "ssm_inner")),
        "A_log": ParamInfo((nh,), ("ssm_heads",), init="a_log"),
        "D": ParamInfo((nh,), ("ssm_heads",), init="ones"),
        "norm": ParamInfo((di,), ("ssm_inner",), init="ones"),
        "wout": ParamInfo((di, d), ("ssm_inner", "embed"), init="scaled"),
    }


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    """RMS norm of y * silu(z), in float32 (the caller casts)."""
    g = y * F.silu(z.float())
    ms = g.square().mean(-1, keepdim=True)
    return g * torch.rsqrt(ms + eps) * scale.float()


def _proj_conv(p, cfg: ArchConfig, x: torch.Tensor):
    """Shared projections. x: (B, S, D) -> z, xBC (pre-conv), dt (float32,
    softplus'd)."""
    z = matmul(x, p["wz"])
    xs = matmul(x, p["wx"])
    Bv = matmul(x, p["wB"])
    Cv = matmul(x, p["wC"])
    dt = F.softplus((matmul(x, p["wdt"]) + p["dt_bias"]).float())
    return z, torch.cat([xs, Bv, Cv], dim=-1), dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. xBC: (B, S, Ch), w: (ck, Ch).  The ck shifted
    slices of the zero-padded input are summed in float32, i = 0..ck-1,
    then SiLU, then the cast back to the input dtype."""
    ck, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, ck - 1, 0))
    w32 = w.float()
    out = torch.zeros(xBC.shape, dtype=torch.float32, device=xBC.device)
    for i in range(ck):
        out = out + pad[:, i:i + S].float() * w32[i]
    return F.silu(out).to(xBC.dtype)


def ssd_forward(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Chunked SSD scan over the full sequence. x: (B, S, D).  S must be a
    multiple of the chunk Q = min(ssm_chunk, S)."""
    S = x.shape[1]
    di, N = cfg.d_inner, cfg.ssm_state
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"SSD scan: sequence length S={S} is not a multiple "
                         f"of the chunk Q={Q}")

    z, xBC, dt = _proj_conv(p, cfg, x)
    xBC = _causal_conv(xBC, p["conv"])
    xs, Bv, Cv = torch.split(xBC, [di, N, N], dim=-1)
    del xBC
    if is_dtensor(xs):
        y = _ssd_sharded(cfg, Q, xs, Bv, Cv, dt, p["A_log"], p["D"])
    else:
        y = _ssd_core(cfg, Q, xs, Bv, Cv, dt, p["A_log"], p["D"])
    y = _gated_norm(y, z, p["norm"], cfg.norm_eps)
    return matmul(y.to(x.dtype), p["wout"])


def _ssd_core(cfg: ArchConfig, Q: int, xs, Bv, Cv, dt, A_log, Dp
              ) -> torch.Tensor:
    """The scan of one rank's rows and heads: xs (B, S, nh*hp), Bv and Cv
    (B, S, N), dt (B, S, nh), A_log and D (nh) -> y (B, S, nh*hp),
    float32 (nh the heads given)."""
    B, S, _ = xs.shape
    N, hp, nh = Bv.shape[-1], cfg.ssm_head_dim, dt.shape[-1]
    nC = S // Q
    xh = xs.reshape(B, nC, Q, nh, hp).float()
    Bc = Bv.reshape(B, nC, Q, N).float()
    Cc = Cv.reshape(B, nC, Q, N).float()
    dtc = dt.reshape(B, nC, Q, nh)

    A = -torch.exp(A_log.float())                            # (nh,)
    cum = torch.cumsum(dtc * A, dim=2)                       # within chunk

    # ---- intra-chunk (quadratic within chunk), as (B, nC, nh, q, k) ----
    scores = Cc @ Bc.transpose(-1, -2)                       # (B,nC,Q,Q)
    cum_h = cum.permute(0, 1, 3, 2)                          # (B,nC,nh,Q)
    L = cum_h[..., :, None] - cum_h[..., None, :]            # q - k
    # mask BEFORE exp: the future branch (q - k >> 0) overflows to inf, and
    # inf * 0 would give NaN in W
    future = torch.ones((Q, Q), dtype=torch.bool,
                        device=xs.device).triu_(1)
    dt_k = dtc.permute(0, 1, 3, 2)[:, :, :, None]
    if torch.is_grad_enabled():  # autograd keeps exp's output: out of place
        W = L.masked_fill(future, -1e30).exp() * scores[:, :, None] * dt_k
    else:                        # the same arithmetic in place
        W = L.masked_fill_(future, -1e30).exp_().mul_(
            scores[:, :, None]).mul_(dt_k)
    del scores
    y_intra = (W @ xh.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)
    del W, L

    # ---- chunk states & inter-chunk recurrence ----
    last = cum[:, :, -1:, :]                                 # (B,nC,1,nh)
    w_in = torch.exp(last - cum) * dtc                       # (B,nC,Q,nh)
    xw = (xh * w_in[..., None]).reshape(B, nC, Q, nh * hp)
    S_chunk = (Bc.transpose(-1, -2) @ xw).view(B, nC, N, nh, hp)
    del xw
    chunk_decay = torch.exp(last[:, :, 0, :])                # (B,nC,nh)

    h = torch.zeros((B, nh, N, hp), dtype=torch.float32, device=xs.device)
    h_prev = torch.empty((B, nC, N, nh, hp), dtype=torch.float32,
                         device=xs.device)
    for c in range(nC):                       # emit the state *before* chunk
        h_prev[:, c] = h.transpose(1, 2)
        h = h * chunk_decay[:, c, :, None, None] \
            + S_chunk[:, c].transpose(1, 2)
    del S_chunk, h

    w_out = torch.exp(cum)                                   # (B,nC,Q,nh)
    y_inter = (Cc @ h_prev.view(B, nC, N, nh * hp)).view(B, nC, Q, nh, hp)
    y_inter = y_inter * w_out[..., None]
    del h_prev

    y = y_intra + y_inter + Dp.float()[:, None] * xh
    return y.reshape(B, S, nh * hp)


def _ssd_sharded(cfg: ArchConfig, Q: int, xs, Bv, Cv, dt, A_log, Dp):
    """:func:`_ssd_core` on each rank's rows and heads through
    ``local_map``: B over the data-parallel axes and the heads over the
    model axis where they divide (the reference pins its scan's initial
    state so, ``constrain(h0, ("dp", "tp", None, None))``); B and C, shared
    by every head, replicated over the model axis.  The gradients of the
    per-head A and D and of B and C are partial sums over the axes whose
    ranks hold other rows or heads."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    rules = current_rules()
    tp = rules.tp_size
    b = rules._dp_entry(xs.shape[0])
    h = rules.tp_axis if cfg.ssm_heads % tp == 0 and \
        cfg.ssm_heads >= tp else None
    pl_x = rules.placements(P(b, None, h))        # xs (B,S,di), dt (B,S,nh)
    pl_bc = rules.placements(P(b, None, None))    # Bv, Cv (B, S, N)
    pl_h = rules.placements(P(h))                 # A_log, D (nh,)
    split_b = rules.placements(P(b))
    split_h = rules.placements(P(h))
    g_h = [Partial() if sb != Replicate() else q
           for sb, q in zip(split_b, pl_h)]       # other rows' sums
    g_bc = [Partial() if sh != Replicate() else q
            for sh, q in zip(split_h, pl_bc)]     # other heads' sums

    def local(xs_, Bv_, Cv_, dt_, A_, D_):
        with use_rules(None):
            return _ssd_core(cfg, Q, xs_, Bv_, Cv_, dt_, A_, D_)
    return local_map(local, out_placements=pl_x,
                     in_placements=(pl_x, pl_bc, pl_bc, pl_x, pl_h, pl_h),
                     in_grad_placements=(pl_x, g_bc, g_bc, pl_x, g_h, g_h),
                     device_mesh=rules.mesh, redistribute_inputs=True)(
        xs, Bv, Cv, dt, A_log, Dp)


# ------------------------------------------------------------- decode


def ssm_init_cache(cfg: ArchConfig, batch: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    di, N, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    return {
        "state": torch.zeros((batch, nh, N, hp), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * N),
                            dtype=dtype, device=device),
    }


def _read_state(Cv: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """C . state per head: Cv (B, N), state (B, nh, N, hp) -> (B, nh,
    hp).  A DTensor state (B over dp, heads over the model axis) is read
    shard by shard through ``local_map``, Cv placed like its B (DTensor's
    batched product cannot follow the heads' shard through the reshape
    it makes)."""
    if not is_dtensor(state):
        return (Cv[:, None, None, :] @ state)[:, :, 0]
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    pl = list(state.placements)
    if any(q != Replicate() and q not in (Shard(0), Shard(1)) for q in pl):
        raise ValueError(f"SSM state placements {pl}: B and heads only")
    c_pl = [q if q == Shard(0) else Replicate() for q in pl]
    return local_map(lambda c, st: (c[:, None, None, :] @ st)[:, :, 0],
                     out_placements=pl, in_placements=(c_pl, pl),
                     device_mesh=state.device_mesh,
                     redistribute_inputs=True)(Cv, state)


def ssm_decode(p, cfg: ArchConfig, x: torch.Tensor,
               cache: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
    """One-token step. x: (B, 1, D).  Writes ``cache["state"]`` and
    ``cache["conv"]`` in place and returns (out, cache)."""
    B = x.shape[0]
    di, N, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    z, xBC, dt = _proj_conv(p, cfg, x)                        # (B,1,*)
    conv = cache["conv"]
    hist = torch.cat([conv, xBC], dim=1)                      # (B,ck,Ch)
    conv_out = (hist.float() * p["conv"].float()).sum(1)      # (B,Ch)
    conv.copy_(hist[:, 1:])          # hist is a new tensor: no overlap
    xs, Bv, Cv = torch.split(F.silu(conv_out), [di, N, N], dim=-1)
    xhead = xs.reshape(B, nh, hp)
    dt1 = dt[:, 0]                                            # (B,nh)
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt1 * A)                                # (B,nh)
    upd = Bv[:, None, :, None] * (dt1[..., None] * xhead)[:, :, None, :]
    state = cache["state"]                                    # (B,nh,N,hp)
    state.mul_(decay[..., None, None]).add_(upd)
    y = _read_state(Cv, state)                                # (B,nh,hp)
    y = y + p["D"].float()[:, None] * xhead
    y = _gated_norm(y.reshape(B, 1, di), z, p["norm"], cfg.norm_eps)
    return matmul(y.to(x.dtype), p["wout"]), cache


def ssd_reference(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Sequential-recurrence oracle (token by token) for tests."""
    B, S, D = x.shape
    cache = ssm_init_cache(cfg, B, x.dtype, x.device)
    outs = []
    for t in range(S):
        o, cache = ssm_decode(p, cfg, x[:, t:t + 1], cache)
        outs.append(o)
    return torch.cat(outs, dim=1)
