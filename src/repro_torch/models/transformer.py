"""Layer stacks, dense part (port of ``repro.models.transformer``).

The reference scans over layers with parameters stacked on a leading
'layers' axis; the port keeps that layout (so parameters carry across
1:1) and loops over it in Python, taking one layer's views per step.
Remat is a training concern and waits for the training slice.  The
reference's ``constrain`` calls (``distributed/context.py``) are sharding
hints with no effect on one card and are left out, as is its
sequence-parallel attention branch.  MoE, SSM, hybrid and
encoder-decoder stacks wait for their slices.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_mlp, apply_norm, mlp_spec, \
    norm_spec
from repro_torch.models.param import stacked


def _dense_gqa_only(cfg: ArchConfig) -> None:
    if cfg.family in ("ssm", "hybrid") or cfg.is_hybrid:
        raise NotImplementedError("SSM and hybrid stacks are not ported yet "
                                  "(ROADMAP queue 1 item 10d)")
    if cfg.uses_moe:
        raise NotImplementedError("MoE layers are not ported yet (ROADMAP "
                                  "queue 1 item 10b)")
    if cfg.attention != "gqa":
        raise NotImplementedError("MLA is not ported yet (ROADMAP queue 1 "
                                  "item 10c)")
    if cfg.is_encoder_decoder or cfg.num_prefix_tokens:
        raise NotImplementedError("encoder-decoder and VLM stacks are not "
                                  "ported yet (ROADMAP queue 1 item 10e)")


def layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ------------------------------------------------------------------ blocks


def attn_block_spec(cfg: ArchConfig, d_ff: int) -> Dict:
    """A dense block (the reference's ``use_moe`` waits for item 10b)."""
    return {"ln1": norm_spec(cfg), "attn": attn.gqa_spec(cfg),
            "ln2": norm_spec(cfg), "ffn": mlp_spec(cfg, d_ff)}


def apply_attn_block(p, cfg: ArchConfig, x: torch.Tensor,
                     positions: torch.Tensor,
                     prefix_len=None) -> torch.Tensor:
    """One pre-norm dense block."""
    h = apply_norm(p["ln1"], x, cfg.norm_eps)
    h = attn.gqa_forward(p["attn"], cfg, h, positions, causal=True,
                         prefix_len=prefix_len)
    x = x + h
    h = apply_norm(p["ln2"], x, cfg.norm_eps)
    return x + apply_mlp(p["ffn"], h, cfg.act)


# --------------------------------------------------------- decoder stacks


def decoder_spec(cfg: ArchConfig) -> Dict[str, Any]:
    """Spec of the dense decoder stack."""
    _dense_gqa_only(cfg)
    return {"layers": stacked(attn_block_spec(cfg, d_ff=cfg.d_ff),
                              cfg.num_layers)}


def apply_decoder(p, cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor,
                  prefix_len=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden, aux_loss_sum): the dense branch, a loop over the
    stacked layers.  Without MoE the router loss is 0."""
    layers = p["layers"]
    for i in range(cfg.num_layers):
        x = apply_attn_block(layer(layers, i), cfg, x, positions,
                             prefix_len=prefix_len)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)
