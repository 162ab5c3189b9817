"""Attention (port of ``repro.models.attention``): GQA with full,
sliding-window and prefix-LM masks, cross-attention, and DeepSeek's MLA;
full-sequence and one-token decode.

Full-sequence attention is ``chunked_attention``.  On a CUDA tensor it
launches the hand-written flash kernel through its one entry,
``kernels.ops.flash_attention_op``: causal self-attention with an
optional window, full self-attention (an encoder), cross-attention (Sq !=
Sk, full, no window) and prefix-LM (causal with an int ``prefix_len``),
with the caller's scale, at the kernel's (q/k head_dim, v head_dim)
pairs; when autograd records for q, k or v (training), through
``kernels.attention.FlashAttentionFn``, whose backward is the
hand-written backward kernels (a full call's zero keys are joined by
``torch.cat``, whose backward drops their gradient, as the reference's
padded scan does).  A full call gets the reference's padded last chunk
as real zero keys on either device, so both attend what the reference
attends.  What the kernel does not take raises (a per-batch
``prefix_len`` tensor, a window on a full call, causal with Sq != Sk);
nothing quietly runs the plain scan on the card.  On a CPU tensor it
runs the plain chunked online-softmax scan, the reference's algorithm
(which autograd differentiates, the reference's training route), which
lives with its mask (the reference's
``_mask``) beside the kernel as the kernel's plain version
(``kernels.attention.chunked_scan``, ``mask``).

Decode attends one query over the cache in plain torch, as the reference
does outside Pallas; MLA decodes in the absorbed form (scores against the
latent cache, never per-head K/V).  The port updates the caches in place
(the reference returns new arrays) and takes the token's position as a
host int, so a decode step issues no device-to-host read.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.context import current_rules, use_rules
from repro_torch.distributed.ops import (flatten_last, is_dtensor, matmul,
                                         unflatten)
from repro_torch.distributed.sharding import P, local_extent
from repro_torch.kernels.attention import NEG_INF, chunked_scan
from repro_torch.kernels.ops import flash_attention_op
from repro_torch.models.layers import apply_norm, rope
from repro_torch.models.param import ParamInfo

PAD_POS = 2**31 - 1          # the reference's position of a padded key


def gqa_spec(cfg: ArchConfig) -> Dict[str, ParamInfo]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    spec = {
        "wq": ParamInfo((d, h, hd), ("embed", "heads", "head")),
        "wk": ParamInfo((d, kv, hd), ("embed", "kv_heads", "head")),
        "wv": ParamInfo((d, kv, hd), ("embed", "kv_heads", "head")),
        "wo": ParamInfo((h, hd, d), ("heads", "head", "embed"), init="scaled"),
    }
    if cfg.qkv_bias:
        spec["bq"] = ParamInfo((h, hd), ("heads", "head"), init="zeros")
        spec["bk"] = ParamInfo((kv, hd), ("kv_heads", "head"), init="zeros")
        spec["bv"] = ParamInfo((kv, hd), ("kv_heads", "head"), init="zeros")
    return spec


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) by w (d, n, h) -> (..., n, h): einsum "bsd,dnh->bsnh"."""
    return unflatten(matmul(x, w.reshape(w.shape[0], -1)), -1, w.shape[1:])


def _out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """o (..., n, h) by w (n, h, d) -> (..., d): einsum "bsnh,nhd->bsd"."""
    return matmul(flatten_last(o), w.reshape(-1, w.shape[-1]))


def chunked_attention(q, k, v, q_pos, k_pos, *, causal: bool,
                      window: int = 0, prefix_len=None, chunk: int = 1024,
                      scale: Optional[float] = None) -> torch.Tensor:
    """The attention entry (see :func:`_chunked_attention_local`).

    Under sharding rules (q, k or v a DTensor) the call runs on each
    rank's shard through ``local_map``: B over the data-parallel axes and
    the heads over the model axis where both H and KV divide it (the
    reference pins its scan's carries B over dp), the rest replicated.
    The kernel, or the plain scan on the CPU, then sees plain local
    tensors, and the gradient flows back through ``local_map``."""
    if not is_dtensor(q, k, v):
        return _chunked_attention_local(q, k, v, q_pos, k_pos, causal=causal,
                                        window=window, prefix_len=prefix_len,
                                        chunk=chunk, scale=scale)
    from torch.distributed.tensor.experimental import local_map
    rules = current_rules()
    if rules is None:
        raise TypeError("chunked_attention: DTensor inputs with no sharding "
                        "rules active")
    B, H, KV = q.shape[0], q.shape[2], k.shape[2]
    tp = rules.tp_size
    heads = rules.tp_axis if H % tp == 0 and KV % tp == 0 and KV >= tp \
        else None
    spec = P(rules._dp_entry(B), None, heads, None)
    pl = rules.placements(spec)
    q, k, v = (rules.place(t, spec) for t in (q, k, v))

    def local(q_, k_, v_):
        with use_rules(None):
            return _chunked_attention_local(
                q_, k_, v_, q_pos, k_pos, causal=causal, window=window,
                prefix_len=prefix_len, chunk=chunk, scale=scale)
    return local_map(local, out_placements=pl, in_placements=(pl, pl, pl),
                     device_mesh=rules.mesh)(q, k, v)


def _chunked_attention_local(q, k, v, q_pos, k_pos, *, causal: bool,
                             window: int = 0, prefix_len=None,
                             chunk: int = 1024,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention.  q: (B, Sq, H, hd); k: (B, Sk, KV, hd);
    v: (B, Sk, KV, hdv).  Returns (B, Sq, H, hdv).

    A full (non-causal) call with Sk % chunk != 0, chunk being the
    reference's KV chunk ``min(chunk, Sk)``, first gets the reference's
    padded last chunk: K and V filled with zero keys at position
    ``PAD_POS``, which a full mask attends (each scores 0, so it adds
    ``exp(-m)`` to the softmax's sum and nothing to its numerator).  A
    causal call's mask rejects such keys, so it is not padded.

    On CUDA the flash kernel runs it and takes query positions as
    0..Sq-1 and key positions as 0..Sk-1: a causal call passes one
    position tensor as both ``q_pos`` and ``k_pos`` (the self-attention
    that ``gqa_forward`` runs); a full call's positions mask nothing.
    Elsewhere the plain chunked scan runs it, ``chunk`` keys at a time.
    """
    Sq, Sk = q.shape[1], k.shape[1]
    extra = 0 if causal else (-Sk) % min(chunk, Sk)
    if extra:
        k, v = (torch.cat([t, t.new_zeros((t.shape[0], extra)
                                          + t.shape[2:])], dim=1)
                for t in (k, v))
        k_pos = torch.cat([k_pos, k_pos.new_full((extra,), PAD_POS)])
    if q.device.type != "cuda":
        return chunked_scan(q, k, v, q_pos, k_pos, causal=causal,
                            window=window, prefix_len=prefix_len,
                            chunk=chunk, scale=scale)
    if torch.is_tensor(prefix_len) and prefix_len.dim() > 0:
        raise NotImplementedError(
            "flash attention takes one int prefix_len, not one a batch row")
    prefix = 0 if prefix_len is None else int(prefix_len)
    if causal and (k_pos is not q_pos or Sk != Sq):
        raise NotImplementedError(
            "flash attention: a causal call is self-attention over "
            "positions 0..S-1 (pass one position tensor as q_pos and "
            "k_pos)")
    if not causal and window > 0:
        raise NotImplementedError(
            "flash attention: a window on a non-causal call")
    return flash_attention_op(q, k, v, causal=causal, window=window,
                              scale=scale, prefix=prefix)


def gqa_forward(p, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
                *, causal: bool = True, prefix_len=None,
                kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                kv_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention (prefill / encoder / cross)."""
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if kv_override is None:
        k, v = gqa_project_kv(p, x, positions, cfg.rope_theta)
        k_pos = positions
    else:
        k, v = kv_override
        k_pos = kv_positions
    q = rope(q, positions, cfg.rope_theta)
    o = chunked_attention(q, k, v, positions, k_pos, causal=causal,
                          window=cfg.sliding_window if causal else 0,
                          prefix_len=prefix_len)
    return _out(o, p["wo"])


def gqa_project_kv(p, x: torch.Tensor, positions: torch.Tensor,
                   theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return rope(k, positions, theta), v


def write_slot(cache: torch.Tensor, slot: int, new: torch.Tensor) -> None:
    """``cache[:, slot] = new[:, 0]`` in place, cast to the cache's dtype.
    A DTensor cache (S over the model axis, maybe B over dp) is written
    on its local shard: ``new`` is placed like the cache with S whole,
    and the rank whose S range holds ``slot`` writes its rows."""
    if not is_dtensor(cache):
        cache[:, slot:slot + 1] = new.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    pl = [Replicate() if isinstance(p_, Shard) and p_.dim == 1 else p_
          for p_ in cache.placements]
    rules = current_rules()
    if rules is None:
        raise TypeError("write_slot: a DTensor cache with no sharding rules "
                        "active")
    if not is_dtensor(new):
        new = rules.place(new, P(*([None] * new.dim())))
    new = new.redistribute(mesh, pl)
    shape, off = local_extent(cache.shape, mesh, cache.placements)
    lo = off[1]
    if lo <= slot < lo + shape[1]:
        cache._local_tensor[:, slot - lo:slot - lo + 1] = \
            new._local_tensor.to(cache.dtype)


def gqa_decode(p, cfg: ArchConfig, x: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, index: int,
               window: int = 0) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """One-token decode. x: (B, 1, D); caches: (B, S_cache, KV, hd).

    ``index`` (a host int) is the absolute position of the new token; with
    a rolling (sliding-window) cache S_cache = window and the token goes
    to slot ``index % S_cache``, else to ``min(index, S_cache - 1)``.  The
    caches are written in place and returned.
    """
    B = x.shape[0]
    S_cache = k_cache.shape[1]
    dev = x.device
    pos = torch.full((B, 1), index, dtype=torch.int32, device=dev)
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    q = rope(q, pos, cfg.rope_theta)
    k_new, v_new = gqa_project_kv(p, x, pos, cfg.rope_theta)
    slot = index % S_cache if window else min(index, S_cache - 1)
    write_slot(k_cache, slot, k_new)
    write_slot(v_cache, slot, v_new)
    # positions held in each cache slot
    slots = torch.arange(S_cache, dtype=torch.int64, device=dev)
    if window:
        # slot s holds the most recent position p with p % window == s,
        # p <= index
        cache_pos = index - (index - slots) % S_cache
        valid = ((index - cache_pos) < window) & (cache_pos >= 0)
    else:
        valid = slots <= index

    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    groups = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = unflatten(q[:, 0], 1, (KV, groups)).float() * scale
    s = torch.einsum("bkgh,bckh->bkgc", qg, k_cache.float())
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgc,bckh->bkgh", w, v_cache.float())
    o = o.reshape(B, 1, H, hd).to(x.dtype)
    return _out(o, p["wo"]), k_cache, v_cache


# ===================================================================== MLA


def mla_spec(cfg: ArchConfig) -> Dict[str, Any]:
    d, h = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rp, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": ParamInfo((d, qr), ("embed", "qlora")),
        "q_norm": {"scale": ParamInfo((qr,), ("qlora",), init="ones")},
        "wq_b": ParamInfo((qr, h, nope + rp), ("qlora", "heads", "head")),
        "wkv_a": ParamInfo((d, kvr), ("embed", "kvlora")),
        "wk_rope": ParamInfo((d, rp), ("embed", "head")),
        "kv_norm": {"scale": ParamInfo((kvr,), ("kvlora",), init="ones")},
        "wk_b": ParamInfo((kvr, h, nope), ("kvlora", "heads", "head")),
        "wv_b": ParamInfo((kvr, h, vh), ("kvlora", "heads", "head")),
        "wo": ParamInfo((h, vh, d), ("heads", "head", "embed"), init="scaled"),
    }


def _mla_qkr(p, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    """Shared q / latent / rope-key computation. x: (B, S, D).  Returns
    q_nope (B, S, H, nope), roped q_rope (B, S, H, rope), the normed latent
    c_kv (B, S, kv_lora) and the roped single-head k_rope (B, S, rope)."""
    nope = cfg.qk_nope_head_dim
    q_lat = apply_norm(p["q_norm"], matmul(x, p["wq_a"]), cfg.norm_eps)
    q = _proj(q_lat, p["wq_b"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    c_kv = apply_norm(p["kv_norm"], matmul(x, p["wkv_a"]), cfg.norm_eps)
    k_rope = matmul(x, p["wk_rope"])[:, :, None, :]  # one head
    k_rope = rope(k_rope, positions, cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(p, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Prefill MLA: the latent expanded to per-head K (nope + the one rope
    key broadcast to every head) and V, then causal ``chunked_attention``
    at q/k head_dim nope + rope, v head_dim ``v_head_dim`` and scale
    ``1/sqrt(nope + rope)``: the flash kernel's (192, 128) pair on the
    card."""
    nope, rp = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_rope, c_kv, k_rope = _mla_qkr(p, cfg, x, positions)
    k_nope = _proj(c_kv, p["wk_b"])
    v = _proj(c_kv, p["wv_b"])
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat(
        [k_nope, k_rope[:, :, None, :].expand(k_nope.shape[:-1] + (rp,))],
        dim=-1)
    o = chunked_attention(q_full, k_full, v, positions, positions,
                          causal=True, scale=1.0 / math.sqrt(nope + rp))
    return _out(o, p["wo"])


def mla_decode(p, cfg: ArchConfig, x: torch.Tensor, c_cache: torch.Tensor,
               r_cache: torch.Tensor, index: int):
    """Absorbed-form MLA decode.  x: (B, 1, D); c_cache: (B, S_cache,
    kv_lora) latent cache; r_cache: (B, S_cache, rope) rope-key cache.

    Scores are taken in latent space: q_eff = q_nope @ wk_b per head
    against the latent cache, plus q_rope against the rope cache; the
    context is re-projected through wv_b, so per-head K/V never exist.
    The token goes to slot ``min(index, S_cache - 1)`` (the reference's
    ``dynamic_update_slice`` clamps its start) while the keys attended are
    slots ``<= index``; the caches are written in place and returned.  The
    dtypes follow the reference's: q_eff and the two score products in
    the parameter dtype, summed, then cast to float32 and scaled; the
    softmax weights cast to the cache dtype before the context; the output
    cast to x's dtype before ``wo``.
    """
    nope, rp = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    B = x.shape[0]
    S_cache = c_cache.shape[1]
    dev = x.device
    pos = torch.full((B, 1), index, dtype=torch.int32, device=dev)
    q_nope, q_rope, c_new, r_new = _mla_qkr(p, cfg, x, pos)
    slot = min(index, S_cache - 1)
    write_slot(c_cache, slot, c_new)
    write_slot(r_cache, slot, r_new)
    q_eff = torch.einsum("bsnh,rnh->bsnr", q_nope, p["wk_b"])  # (B,1,H,r)
    s = (torch.einsum("bsnr,bcr->bnc", q_eff, c_cache.to(q_eff.dtype))
         + torch.einsum("bsnr,bcr->bnc", q_rope, r_cache.to(q_rope.dtype)))
    s = s.float() * (1.0 / math.sqrt(nope + rp))
    valid = torch.arange(S_cache, device=dev) <= index
    s = torch.where(valid[None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bnc,bcr->bnr", w.to(c_cache.dtype), c_cache)
    o = torch.einsum("bnr,rnh->bnh", ctx, p["wv_b"])[:, None]  # (B,1,H,vh)
    return _out(o.to(x.dtype), p["wo"]), c_cache, r_cache
