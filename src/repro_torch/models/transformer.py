"""Layer stacks (port of ``repro.models.transformer``): dense and
mixture-of-experts blocks with GQA or MLA attention, and the leading
dense stack (``first_k_dense``) in front of the main one.

The reference scans over layers with parameters stacked on a leading
'layers' axis; the port keeps that layout (so parameters carry across
1:1) and loops over it in Python, taking one layer's views per step.
Remat is a training concern and waits for the training slice.  The
reference's ``constrain`` calls (``distributed/context.py``) are sharding
hints with no effect on one card and are left out, as is its
sequence-parallel attention branch.  SSM, hybrid and encoder-decoder
stacks wait for their slices.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import apply_mlp, apply_norm, mlp_spec, \
    norm_spec
from repro_torch.models.param import stacked


def _refuse_ssm_and_encoder_stacks(cfg: ArchConfig) -> None:
    """Raise, naming the ROADMAP item, for a stack the port lacks: SSM and
    hybrid (item 10d), encoder-decoder and VLM (item 10e)."""
    if cfg.family in ("ssm", "hybrid") or cfg.is_hybrid:
        raise NotImplementedError("SSM and hybrid stacks are not ported yet "
                                  "(ROADMAP queue 1 item 10d)")
    if cfg.is_encoder_decoder or cfg.num_prefix_tokens:
        raise NotImplementedError("encoder-decoder and VLM stacks are not "
                                  "ported yet (ROADMAP queue 1 item 10e)")


def layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


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
    h = apply_norm(p["ln1"], x, cfg.norm_eps)
    if cfg.attention == "mla":
        h = attn.mla_forward(p["attn"], cfg, h, positions)
    else:
        h = attn.gqa_forward(p["attn"], cfg, h, positions, causal=True,
                             prefix_len=prefix_len)
    x = x + h
    h = apply_norm(p["ln2"], x, cfg.norm_eps)
    if use_moe:
        h, aux = moe_lib.apply_moe(p["ffn"], cfg, h)
    else:
        h = apply_mlp(p["ffn"], h, cfg.act)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h, aux


# --------------------------------------------------------- decoder stacks


def decoder_spec(cfg: ArchConfig) -> Dict[str, Any]:
    """Spec of the decoder stack: ``first_k_dense`` leading dense layers
    (``dense_layers``) of a MoE arch, then the main ``layers``."""
    _refuse_ssm_and_encoder_stacks(cfg)
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
    stack, each a loop over its stacked layers; the aux losses summed in
    layer order (0 without MoE)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for name, use_moe in (("dense_layers", False), ("layers", cfg.uses_moe)):
        if name not in p:
            continue
        stack = p[name]
        for i in range(len(stack["ln1"]["scale"])):     # the stack's depth
            x, a = apply_attn_block(layer(stack, i), cfg, x, positions,
                                    use_moe, prefix_len=prefix_len)
            aux = aux + a
    return x, aux
