"""Shared neural layers (port of ``repro.models.layers``): norms, MLPs,
embeddings, rotary/sinusoidal positions.

All ``*_spec`` functions return nested dicts of ParamInfo; the ``apply``
functions are plain torch on the matching dict of tensors.  The compute
dtype follows the input; normalisation and the rotary angles are float32,
as in the reference.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.ops import matmul
from repro_torch.models.param import ParamInfo

# ----------------------------------------------------------------- norms


def norm_spec(cfg: ArchConfig, d: Optional[int] = None) -> Dict[str, ParamInfo]:
    d = d or cfg.d_model
    spec = {"scale": ParamInfo((d,), ("embed",), init="ones")}
    if cfg.norm == "layernorm":
        spec["bias"] = ParamInfo((d,), ("embed",), init="zeros")
    return spec


def apply_norm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm (or LayerNorm with a bias), accumulated in float32 and cast
    back to ``x``'s dtype."""
    x32 = x.float()
    if "bias" in p:  # layernorm
        mu = x32.mean(-1, keepdim=True)
        var = (x32 - mu).square().mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = x32.square().mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


# ----------------------------------------------------------------- MLP


def mlp_spec(cfg: ArchConfig, d_ff: int) -> Dict[str, ParamInfo]:
    d = cfg.d_model
    if cfg.act == "silu":  # SwiGLU
        return {
            "wi": ParamInfo((d, d_ff), ("embed", "mlp")),
            "wg": ParamInfo((d, d_ff), ("embed", "mlp")),
            "wo": ParamInfo((d_ff, d), ("mlp", "embed"), init="scaled"),
        }
    return {
        "wi": ParamInfo((d, d_ff), ("embed", "mlp")),
        "wo": ParamInfo((d_ff, d), ("mlp", "embed"), init="scaled"),
    }


def apply_mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    h = matmul(x, p["wi"])
    if act == "silu":
        h = F.silu(h) * matmul(x, p["wg"])
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return matmul(h, p["wo"])


# ----------------------------------------------------------------- embeddings


def embedding_spec(cfg: ArchConfig) -> Dict[str, ParamInfo]:
    spec = {"embedding": ParamInfo((cfg.padded_vocab, cfg.d_model),
                                   ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        spec["head"] = ParamInfo((cfg.d_model, cfg.padded_vocab),
                                 ("embed", "vocab"))
    return spec


def embed_tokens(p, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return F.embedding(tokens, p["embedding"]).to(dtype)


def logits_from(p, x: torch.Tensor) -> torch.Tensor:
    if "head" in p:
        return matmul(x, p["head"])
    return matmul(x, p["embedding"].T)


# ----------------------------------------------------------------- positions


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, head_dim), positions: (..., S)."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    half = hd // 2
    freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=x.device) / half))
    ang = positions[..., None].float() * freq        # (..., S, half)
    cos = torch.cos(ang)[..., None, :]               # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def sinusoidal_positions(seq_len: int, d: int, dtype,
                         device=None) -> torch.Tensor:
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, dim / d)
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return pe[:, :d].to(dtype)
