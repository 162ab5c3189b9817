"""Layer stacks (port of ``repro.models.transformer``): dense and
mixture-of-experts blocks with GQA or MLA attention, the leading dense
stack (``first_k_dense``) in front of the main one, the attention-free
Mamba2 stack, Jamba's hybrid periods, and Whisper's encoder (full
self-attention, ``ln_post``) and cross-attending decoder.

The reference scans over layers with parameters stacked on a leading
'layers' axis; the port keeps that layout (so parameters carry across
1:1) and loops over it in Python, taking one layer's views per step.
Each layer's body is checkpointed by ``cfg.remat`` as the reference's
``_remat`` wraps its scanned body, but only while autograd records
(inference never checkpoints): "full" keeps nothing of the body and runs
it again in the backward, "dots" keeps the outputs of the matrix
products (``aten.mm``/``aten.addmm``, the reference's
``dots_with_no_batch_dims_saveable``) and recomputes the rest.  The
reference's ``constrain`` calls sit at the same places
(``repro_torch.distributed.context``): each block's input is pinned B
over the data-parallel axes, and under ``seq_parallel_attn`` an
attention block whose head count does not divide the model axis runs
its attention input with S over that axis.  With no sharding rules
active they return their input.  A VLM's prefix-LM mask reaches every
block through ``apply_decoder``'s ``prefix_len``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.context import (checkpoint_context_fn,
                                             constrain, current_rules)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import apply_mlp, apply_norm, mlp_spec, \
    norm_spec
from repro_torch.models.param import stacked


def layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def depth(tree) -> int:
    """The leading (layers) extent of a stacked parameter tree."""
    v = next(iter(tree.values()))
    return depth(v) if isinstance(v, dict) else v.shape[0]


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, mode: str):
    """One layer's body ``fn`` under ``cfg.remat``: itself for "none" or
    when autograd does not record, else checkpointed ("full": nothing
    kept; "dots": the products' outputs kept), its recomputation under
    the sharding rules of the forward."""
    if mode == "none" or not torch.is_grad_enabled():
        return fn
    if mode not in ("full", "dots"):
        raise ValueError(f"remat: {mode!r} is not none, full or dots")
    inner = None if mode == "full" else functools.partial(
        create_selective_checkpoint_contexts, _save_dots)
    ctx = checkpoint_context_fn(inner)
    kw = {} if ctx is None else {"context_fn": ctx}
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


# ------------------------------------------------------------------ blocks


def attn_block_spec(cfg: ArchConfig, use_moe: bool, d_ff: int) -> Dict:
    a = attn.mla_spec(cfg) if cfg.attention == "mla" else attn.gqa_spec(cfg)
    ffn = moe_lib.moe_spec(cfg) if use_moe else mlp_spec(cfg, d_ff)
    return {"ln1": norm_spec(cfg), "attn": a, "ln2": norm_spec(cfg),
            "ffn": ffn}


def apply_attn_block(p, cfg: ArchConfig, x: torch.Tensor,
                     positions: torch.Tensor, use_moe: bool,
                     prefix_len=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pre-norm block: (x, the router's aux loss; 0 for a dense FFN)."""
    x = constrain(x, ("dp", None, None))
    h = apply_norm(p["ln1"], x, cfg.norm_eps)
    rules = current_rules()
    sp = (rules is not None and rules.seq_parallel_attn and cfg.num_heads
          and cfg.num_heads % rules.tp_size != 0)
    if sp:  # sequence-parallel attention: S over the idle model axis
        h = constrain(h, ("dp", "tp", None))
    if cfg.attention == "mla":
        h = attn.mla_forward(p["attn"], cfg, h, positions)
    else:
        h = attn.gqa_forward(p["attn"], cfg, h, positions, causal=True,
                             prefix_len=prefix_len)
    if sp:
        h = constrain(h, ("dp", None, None))
    x = x + h
    h = apply_norm(p["ln2"], x, cfg.norm_eps)
    if use_moe:
        h, aux = moe_lib.apply_moe(p["ffn"], cfg, h)
    else:
        h = apply_mlp(p["ffn"], h, cfg.act)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h, aux


def ffn_residual(p, cfg: ArchConfig, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The FFN half of a block: (x + FFN(norm(x)), the router's aux loss),
    a MoE where the block's FFN has a router; a dense FFN's aux is None
    (no device op for a zero)."""
    h = apply_norm(p["ln2"], x, cfg.norm_eps)
    if "router" in p["ffn"]:
        h, aux = moe_lib.apply_moe(p["ffn"], cfg, h)
    else:
        h, aux = apply_mlp(p["ffn"], h, cfg.act), None
    return x + h, aux


def ssm_block_spec(cfg: ArchConfig) -> Dict:
    return {"ln": norm_spec(cfg), "ssm": ssm_lib.ssm_spec(cfg)}


def apply_ssm_block(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = constrain(x, ("dp", None, None))
    h = apply_norm(p["ln"], x, cfg.norm_eps)
    return x + ssm_lib.ssd_forward(p["ssm"], cfg, h)


# --------------------------------------------------------- decoder stacks


def decoder_spec(cfg: ArchConfig) -> Dict[str, Any]:
    """Spec of the decoder stack: SSM blocks (``family == "ssm"``), Jamba
    periods of ``attn_period`` sublayers (hybrid), or ``first_k_dense``
    leading dense layers (``dense_layers``) of a MoE arch, then the main
    ``layers``."""
    if cfg.family == "ssm":
        return {"layers": stacked(ssm_block_spec(cfg), cfg.num_layers)}
    if cfg.is_hybrid:
        return {"layers": stacked(_jamba_block_spec(cfg),
                                  cfg.num_layers // cfg.attn_period)}
    spec: Dict[str, Any] = {}
    n_dense = cfg.first_k_dense if cfg.uses_moe else 0
    if n_dense:
        spec["dense_layers"] = stacked(
            attn_block_spec(cfg, use_moe=False, d_ff=cfg.d_ff), n_dense)
    spec["layers"] = stacked(
        attn_block_spec(cfg, use_moe=cfg.uses_moe,
                        d_ff=cfg.d_ff or cfg.moe_d_ff),
        cfg.num_layers - n_dense)
    return spec


def apply_decoder(p, cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor,
                  prefix_len=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden, aux_loss_sum): the dense stack, then the main
    stack, each a loop over its stacked layers (periods for a hybrid); the
    aux losses summed in layer order (0 without MoE)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    stack = p["layers"]
    if cfg.family == "ssm":
        body = _remat(apply_ssm_block, cfg.remat)
        for i in range(depth(stack)):
            x = body(layer(stack, i), cfg, x)
        return x, aux
    if cfg.is_hybrid:
        body = _remat(_apply_jamba_block, cfg.remat)
        for i in range(depth(stack)):
            x, a = body(layer(stack, i), cfg, x, positions)
            aux = aux + a
        return x, aux
    body = _remat(apply_attn_block, cfg.remat)
    for name, use_moe in (("dense_layers", False), ("layers", cfg.uses_moe)):
        if name not in p:
            continue
        stack = p[name]
        for i in range(depth(stack)):
            x, a = body(layer(stack, i), cfg, x, positions, use_moe,
                        prefix_len)
            aux = aux + a
    return x, aux


# ------------------------------------------------------------- Jamba block


def _jamba_block_spec(cfg: ArchConfig) -> Dict:
    """One period of cfg.attn_period sublayers: attention at period//2,
    SSM elsewhere; MoE FFN on the sublayers i % moe_period ==
    moe_period - 1."""
    spec = {}
    for i in range(cfg.attn_period):
        is_attn = i == cfg.attn_period // 2
        is_moe = bool(cfg.moe_period) and \
            i % cfg.moe_period == cfg.moe_period - 1
        if is_attn:
            sub = {"ln1": norm_spec(cfg), "attn": attn.gqa_spec(cfg)}
        else:
            sub = {"ln1": norm_spec(cfg), "ssm": ssm_lib.ssm_spec(cfg)}
        sub["ln2"] = norm_spec(cfg)
        sub["ffn"] = (moe_lib.moe_spec(cfg) if is_moe
                      else mlp_spec(cfg, cfg.d_ff))
        spec[f"sub{i}"] = sub
    return spec


def _apply_jamba_block(p, cfg: ArchConfig, x: torch.Tensor,
                       positions: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One period, sublayer by sublayer; the MoE aux losses summed in
    sublayer order."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.attn_period):
        sub = p[f"sub{i}"]
        x = constrain(x, ("dp", None, None))
        h = apply_norm(sub["ln1"], x, cfg.norm_eps)
        if "attn" in sub:
            h = attn.gqa_forward(sub["attn"], cfg, h, positions, causal=True)
        else:
            h = ssm_lib.ssd_forward(sub["ssm"], cfg, h)
        x, a = ffn_residual(sub, cfg, x + h)
        if a is not None:
            aux = aux + a
    return x, aux


# --------------------------------------------------------------- encoder


def encoder_spec(cfg: ArchConfig) -> Dict:
    return {"layers": stacked(attn_block_spec(cfg, use_moe=False,
                                              d_ff=cfg.d_ff),
                              cfg.num_encoder_layers),
            "ln_post": norm_spec(cfg)}


def apply_encoder(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Bidirectional encoder over precomputed frame embeddings x (B, S,
    D): pre-norm blocks with full self-attention, then ``ln_post``."""
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    stack = p["layers"]
    body = _remat(_encoder_block, cfg.remat)
    for i in range(depth(stack)):
        x = body(layer(stack, i), cfg, x, positions)
    return apply_norm(p["ln_post"], x, cfg.norm_eps)


def _encoder_block(lp, cfg: ArchConfig, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    x = constrain(x, ("dp", None, None))
    h = apply_norm(lp["ln1"], x, cfg.norm_eps)
    x = x + attn.gqa_forward(lp["attn"], cfg, h, positions, causal=False)
    h = apply_norm(lp["ln2"], x, cfg.norm_eps)
    return x + apply_mlp(lp["ffn"], h, cfg.act)


# ----------------------------------------------------- enc-dec decoder


def xdecoder_spec(cfg: ArchConfig) -> Dict:
    sub = attn_block_spec(cfg, use_moe=False, d_ff=cfg.d_ff)
    sub["ln_x"] = norm_spec(cfg)
    sub["xattn"] = attn.gqa_spec(cfg)
    return {"layers": stacked(sub, cfg.num_layers)}


def apply_xdecoder(p, cfg: ArchConfig, x: torch.Tensor,
                   positions: torch.Tensor,
                   enc_out: torch.Tensor) -> torch.Tensor:
    """The encoder-decoder's decoder: each block causal self-attention,
    then cross-attention over ``enc_out`` (its K/V projected by the
    block's ``xattn``), then the MLP, each pre-norm with a residual."""
    enc_pos = torch.arange(enc_out.shape[1], dtype=torch.int32,
                           device=x.device)
    stack = p["layers"]
    body = _remat(_xdecoder_block, cfg.remat)
    for i in range(depth(stack)):
        x = body(layer(stack, i), cfg, x, positions, enc_out, enc_pos)
    return x


def _xdecoder_block(lp, cfg: ArchConfig, x: torch.Tensor,
                    positions: torch.Tensor, enc_out: torch.Tensor,
                    enc_pos: torch.Tensor) -> torch.Tensor:
    x = constrain(x, ("dp", None, None))
    h = apply_norm(lp["ln1"], x, cfg.norm_eps)
    x = x + attn.gqa_forward(lp["attn"], cfg, h, positions, causal=True)
    h = apply_norm(lp["ln_x"], x, cfg.norm_eps)
    k, v = attn.gqa_project_kv(lp["xattn"], enc_out, enc_pos, cfg.rope_theta)
    x = x + attn.gqa_forward(lp["xattn"], cfg, h, positions, causal=False,
                             kv_override=(k, v), kv_positions=enc_pos)
    h = apply_norm(lp["ln2"], x, cfg.norm_eps)
    return x + apply_mlp(lp["ffn"], h, cfg.act)
