"""Top-level model API (port of ``repro.models.model``), driven by ArchConfig.

    model = Model(cfg, device="cuda").init(generator)  # or convert.from_jax_params
    loss, metrics = model.loss_fn(batch)                # training loss
    logits = model.prefill_logits(batch)                # parallel prefill
    cache  = model.init_cache(batch_size, cache_len)    # decode state
    logits, cache = model.decode_step(cache, tokens)    # one token

The parameters live in the module, as a tree of submodules with the
reference's names and layouts (``decoder.layers.attn.wq`` is
(L, d, H, hd)); ``model.params`` is the same tree as a nested dict, which
the layer functions take.  The parameters are created with
``requires_grad=False``; training turns gradients on with
``model.requires_grad_(True)`` (``training.step.init_train_state`` does),
and the inference entries (``prefill_logits``, ``decode_step``,
``prefill_with_cache``) run under ``torch.no_grad()`` whatever the
parameters say.  Batches are dicts with ``tokens`` (B, S) ints,
``labels`` (B, S) ints for the loss (-1 = ignore), plus ``enc_inputs``
(B, enc_len, D), the audio stub's frame embeddings, for an
encoder-decoder, or ``prefix`` (B, num_prefix_tokens, D), the vision
stub's patch embeddings, for a VLM.

The port runs every family of the reference: the GQA ones, dense and
mixture of experts, DeepSeek's MLA with its leading dense stack and its
multi-token prediction (MTP) head's parameters, the Mamba2 SSM stack,
Jamba's hybrid periods, Whisper's encoder-decoder and PaliGemma's
prefix-LM decoder, and the training loss of each (``loss_fn``: the
cross-entropy over logits made 1,024 positions at a time, the router's
aux loss, DeepSeek's MTP loss).  As in the reference, a VLM's decode sees
no prefix (its decode path has none), and ``decode_step`` of an
encoder-decoder attends whatever the cache's ``xk``/``xv`` hold: zeros
from ``init_cache``, the encoder's projections after
``prefill_with_cache``.  Decode keeps the cache index as a host int and
writes the caches in place.
"""
from __future__ import annotations

import math
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.context import (checkpoint_context_fn,
                                             constrain, constrain_cache,
                                             constrain_decode_act,
                                             current_rules)
from repro_torch.distributed.sharding import cache_kind
from repro_torch.distributed.ops import is_dtensor, matmul, unflatten
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (apply_norm, embed_tokens,
                                       embedding_spec, logits_from, norm_spec,
                                       sinusoidal_positions)
from repro_torch.models.param import ParamInfo, init_params, leaves, \
    param_count


def _module_tree(tree: Dict[str, Any]) -> nn.Module:
    node = nn.Module()
    for k, v in tree.items():
        if isinstance(v, dict):
            node.add_module(k, _module_tree(v))
        else:
            node.register_parameter(k, nn.Parameter(v, requires_grad=False))
    return node


def _dict_tree(module: nn.Module) -> Dict[str, Any]:
    out: Dict[str, Any] = dict(module._parameters)
    for k, m in module._modules.items():
        out[k] = _dict_tree(m)
    return out


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.param_dtype)

    # ------------------------------------------------------------ params
    def spec(self) -> Dict[str, Any]:
        cfg = self.cfg
        s: Dict[str, Any] = {"embed": embedding_spec(cfg),
                             "ln_f": norm_spec(cfg),
                             "decoder": tfm.decoder_spec(cfg)}
        if cfg.is_encoder_decoder:
            s["encoder"] = tfm.encoder_spec(cfg)
            s["decoder"] = tfm.xdecoder_spec(cfg)
        if cfg.mtp_depth:        # DeepSeek-V3's multi-token prediction head
            s["mtp"] = {
                "proj": ParamInfo((2 * cfg.d_model, cfg.d_model),
                                  ("embed", "embed")),
                "ln": norm_spec(cfg),
                "block": tfm.attn_block_spec(cfg, use_moe=False,
                                             d_ff=cfg.d_ff or cfg.moe_d_ff),
            }
        return s

    def axes(self) -> Dict[str, Tuple[Optional[str], ...]]:
        """{dotted parameter name: its logical axes} from the spec, which
        the sharding rules map onto mesh axes."""
        return {name: info.axes for name, info in leaves(self.spec())}

    def param_count(self) -> int:
        """From the spec alone: nothing is allocated."""
        return param_count(self.spec())

    def init(self, generator: Optional[torch.Generator] = None,
             seed: int = 0) -> "Model":
        """Random parameters by the reference's init rules, drawn from
        ``generator`` (a ``torch.Generator`` on the model's device; one
        seeded with ``seed`` when none is given)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        return self.load_params(init_params(self.spec(), generator,
                                            self.dtype, self.device))

    def load_params(self, tree: Dict[str, Any]) -> "Model":
        """Install a nested dict of tensors with the spec's names and
        shapes, cast to the model's dtype and device."""
        want = dict(leaves(self.spec()))
        got = dict(leaves(tree))
        if set(want) != set(got):
            raise ValueError(
                f"parameter names differ from the spec: missing "
                f"{sorted(set(want) - set(got))}, extra "
                f"{sorted(set(got) - set(want))}")
        for name, info in want.items():
            if tuple(got[name].shape) != tuple(info.shape):
                raise ValueError(f"{name}: shape {tuple(got[name].shape)} "
                                 f"!= spec {info.shape}")
        cast = {}
        for name, t in got.items():
            node = cast
            *path, last = name.split(".")
            for k in path:
                node = node.setdefault(k, {})
            node[last] = t.to(device=self.device, dtype=self.dtype)
        for k, sub in cast.items():
            self.add_module(k, _module_tree(sub))
        return self

    @property
    def params(self) -> Dict[str, Any]:
        """The parameters as a nested dict (the reference's tree)."""
        return {k: _dict_tree(m) for k, m in self._modules.items()}

    # ----------------------------------------------------------- forward
    def _tokens(self, tokens) -> torch.Tensor:
        if torch.is_tensor(tokens):
            return tokens.to(device=self.device, dtype=torch.long)
        return torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=self.device)

    def _embeddings(self, a) -> torch.Tensor:
        """Stub frame or patch embeddings in the model's dtype and device
        (the reference's ``astype`` to the token embeddings' dtype)."""
        if not torch.is_tensor(a):
            a = torch.as_tensor(np.asarray(a))
        return a.to(device=self.device, dtype=self.dtype)

    def _embed_sequence(self, params, batch) -> Tuple[torch.Tensor,
                                                      torch.Tensor, Any]:
        """Returns (x, positions, prefix_len): a VLM's patch embeddings
        before the tokens, attended in full (``prefix_len`` =
        ``num_prefix_tokens``), sinusoidal positions added where the arch
        has no RoPE (Whisper's decoder)."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], self._tokens(batch["tokens"]),
                         self.dtype)
        prefix_len = None
        if cfg.num_prefix_tokens:
            # under rules a vocab-sharded lookup is a partial sum: reduce
            # it before the concatenation
            x = torch.cat([self._embeddings(batch["prefix"]),
                           constrain(x, ("dp", None, None))], dim=1)
            prefix_len = cfg.num_prefix_tokens
        S = x.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=self.device)
        if cfg.rope_theta <= 0 and not cfg.is_ssm and not cfg.is_hybrid:
            x = x + sinusoidal_positions(S, cfg.d_model, x.dtype,
                                         self.device)[None]
        x = constrain(x, ("dp", None, None))
        return x, positions, prefix_len

    def encode(self, batch) -> torch.Tensor:
        """An encoder-decoder's encoder over ``batch["enc_inputs"]``."""
        return tfm.apply_encoder(self.params["encoder"], self.cfg,
                                 self._embeddings(batch["enc_inputs"]))

    def hidden_states(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Final-norm hidden states + aux (router) loss."""
        cfg = self.cfg
        params = self.params
        x, positions, prefix_len = self._embed_sequence(params, batch)
        if cfg.is_encoder_decoder:
            x = tfm.apply_xdecoder(params["decoder"], cfg, x, positions,
                                   self.encode(batch))
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        else:
            x, aux = tfm.apply_decoder(params["decoder"], cfg, x, positions,
                                       prefix_len=prefix_len)
        return apply_norm(params["ln_f"], x, cfg.norm_eps), aux

    @torch.no_grad()
    def prefill_logits(self, batch) -> torch.Tensor:
        """Parallel prefill: float32 logits (B, S, padded vocab)."""
        h, _ = self.hidden_states(batch)
        return logits_from(self.params["embed"], h).float()

    # -------------------------------------------------------------- loss
    def loss_fn(self, batch, ce_chunk: int = 1024):
        """(total loss, metrics): the mean cross-entropy over the labels
        that are not -1 (a VLM's prefix positions carry none), plus 0.01 x
        the router's aux loss and, with an MTP head, 0.3 x its loss; the
        metrics ``ce``, ``aux``, ``tokens`` (labels counted) and ``mtp``,
        detached 0-d float32 tensors."""
        cfg = self.cfg
        h, aux = self.hidden_states(batch)
        if cfg.num_prefix_tokens:            # loss only on text positions
            h = h[:, cfg.num_prefix_tokens:]
        labels = self._tokens(batch["labels"])
        loss, denom = _chunked_ce(self.params["embed"], h, labels, ce_chunk)
        ce = loss / denom.clamp_min(1.0)
        metrics = {"ce": ce.detach(), "aux": aux.detach(),
                   "tokens": denom.detach()}
        total = ce + 0.01 * aux
        if cfg.mtp_depth:
            mtp_loss = self._mtp_loss(h, batch, labels, ce_chunk)
            total = total + 0.3 * mtp_loss
            metrics["mtp"] = mtp_loss.detach()
        return total, metrics

    def _mtp_loss(self, h, batch, labels, ce_chunk: int) -> torch.Tensor:
        """DeepSeek-V3 multi-token prediction: predict t+2 from [h_t ;
        emb(token_{t+1})] through one extra block."""
        cfg = self.cfg
        params = self.params
        p = params["mtp"]
        emb_next = constrain(embed_tokens(params["embed"],
                                          self._tokens(batch["tokens"])[:, 1:],
                                          h.dtype), ("dp", None, None))
        z = torch.cat([apply_norm(p["ln"], h[:, :-1], cfg.norm_eps),
                       emb_next], dim=-1)
        z = matmul(z, p["proj"])
        positions = torch.arange(z.shape[1], dtype=torch.int32,
                                 device=self.device)
        z, _ = tfm.apply_attn_block(p["block"], cfg, z, positions,
                                    use_moe=False)
        mtp_labels = F.pad(labels[:, 2:], (0, 1), value=-1)
        loss, denom = _chunked_ce(params["embed"], z, mtp_labels, ce_chunk)
        return loss / denom.clamp_min(1.0)

    # ------------------------------------------------------------ decode
    def init_cache(self, batch_size: int, cache_len: int,
                   enc_len: Optional[int] = None) -> Dict[str, Any]:
        """Decode state in the parameter dtype, with kv_len = min(cache_len,
        window) for a sliding window (a rolling cache), and the host int
        ``index``.  GQA: k/v (L, B, kv_len, KV, hd), and for an
        encoder-decoder the cross K/V xk/xv (L, B, enc_len or
        ``encoder_seq_len``, KV, hd), zeros.  MLA: the latent c
        (L, B, kv_len, kv_lora_rank) and the rope keys r (L, B, kv_len,
        rope_dim), the leading dense layers first.  SSM: the state
        (L, B, nh, N, hp) in float32 and the conv window (L, B, ck-1,
        d_inner + 2N).  Hybrid: k/v (n_periods, B, kv_len, KV, hd) and a
        ``state{i}``/``conv{i}`` pair for each SSM sublayer i of a
        period."""
        cfg = self.cfg
        kv_len = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
            else cache_len
        L, B = cfg.num_layers, batch_size
        ssm_state = (B, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)
        ssm_conv = (B, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
        if cfg.family == "ssm":
            shapes = {"state": (L,) + ssm_state, "conv": (L,) + ssm_conv}
        elif cfg.is_hybrid:
            nb = cfg.num_layers // cfg.attn_period
            shape = (nb, B, kv_len, cfg.num_kv_heads, cfg.resolved_head_dim)
            shapes = {"k": shape, "v": shape}
            for i in range(cfg.attn_period):
                if i != cfg.attn_period // 2:
                    shapes[f"state{i}"] = (nb,) + ssm_state
                    shapes[f"conv{i}"] = (nb,) + ssm_conv
        elif cfg.attention == "mla":
            shapes = {"c": (L, B, kv_len, cfg.kv_lora_rank),
                      "r": (L, B, kv_len, cfg.qk_rope_head_dim)}
        else:
            shape = (L, B, kv_len, cfg.num_kv_heads, cfg.resolved_head_dim)
            shapes = {"k": shape, "v": shape}
            if cfg.is_encoder_decoder:
                xshape = (L, B, enc_len or cfg.encoder_seq_len,
                          cfg.num_kv_heads, cfg.resolved_head_dim)
                shapes.update(xk=xshape, xv=xshape)
        cache: Dict[str, Any] = {"index": 0}
        for k, shape in shapes.items():       # SSM states are float32
            cache[k] = torch.zeros(
                shape, dtype=torch.float32 if k.startswith("state")
                else self.dtype, device=self.device)
        return cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, index: Optional[int] = None):
        """tokens: (B, 1) ints.  Returns (logits (B, V) float32, cache); the
        cache is updated in place and its host int ``index`` advanced."""
        cfg = self.cfg
        params = self.params
        index = cache["index"] if index is None else int(index)
        rules = current_rules()
        if rules is not None:        # the caches on their placements
            for key, t in cache.items():
                kind = cache_kind(key)
                if kind is not None:
                    cache[key] = rules.place(
                        t, rules.cache_pspec(tuple(t.shape), kind))
        x = embed_tokens(params["embed"], self._tokens(tokens), self.dtype)
        if cfg.rope_theta <= 0 and not cfg.is_ssm and not cfg.is_hybrid:
            pe = sinusoidal_positions(index + 1, cfg.d_model, x.dtype,
                                      self.device)
            x = x + pe[index:index + 1][None]
        x = self._decode_layers(params, cache, x, index)
        cache["index"] = index + 1
        h = apply_norm(params["ln_f"], x, cfg.norm_eps)
        logits = logits_from(params["embed"], h)[:, 0].float()
        return logits, cache

    def _decode_layers(self, params, cache, x, index: int) -> torch.Tensor:
        """One token through the ``first_k_dense`` dense layers, then the
        main stack: layer i of the cache is layer i of that order.  GQA
        attends its k/v cache (and, as the reference's GQA body at
        ``model.py:245-246``, has no leading dense stack), then an
        encoder-decoder's block its cross cache xk/xv; MLA its latent
        c/r cache, in the absorbed form.  An SSM layer steps its state and
        conv window; a hybrid period runs its sublayers in order, the
        attention one on the period's k/v, SSM sublayer i on
        ``state{i}``/``conv{i}``."""
        cfg = self.cfg
        dec = params["decoder"]
        if cfg.family == "ssm":
            stack = dec["layers"]
            for i in range(tfm.depth(stack)):
                lp = tfm.layer(stack, i)
                x = constrain_decode_act(x)
                a = apply_norm(lp["ln"], x, cfg.norm_eps)
                a, _ = ssm_lib.ssm_decode(lp["ssm"], cfg, a, {
                    "state": constrain_cache(cache["state"][i], "state"),
                    "conv": constrain_cache(cache["conv"][i], "conv")})
                x = x + a
            return x
        if cfg.is_hybrid:
            stack = dec["layers"]
            for j in range(tfm.depth(stack)):
                lp = tfm.layer(stack, j)
                x = constrain_decode_act(x)
                for i in range(cfg.attn_period):
                    x = self._sublayer_decode(lp[f"sub{i}"], cache, x, index,
                                              j, i)
            return x
        mla = cfg.attention == "mla"
        if "dense_layers" in dec and not mla:
            raise NotImplementedError("GQA decode with first_k_dense "
                                      "leading dense layers")
        i = 0
        for name in ("dense_layers", "layers"):
            if name not in dec:
                continue
            stack = dec[name]
            for j in range(tfm.depth(stack)):
                lp = tfm.layer(stack, j)
                x = constrain_decode_act(x)
                a = apply_norm(lp["ln1"], x, cfg.norm_eps)
                if mla:
                    a, _, _ = attn.mla_decode(
                        lp["attn"], cfg, a, constrain_cache(cache["c"][i], "mla"),
                        constrain_cache(cache["r"][i], "mla"), index)
                else:
                    a, _, _ = attn.gqa_decode(
                        lp["attn"], cfg, a, constrain_cache(cache["k"][i], "kv"),
                        constrain_cache(cache["v"][i], "kv"), index,
                        window=cfg.sliding_window)
                x = x + a
                if cfg.is_encoder_decoder:
                    a = apply_norm(lp["ln_x"], x, cfg.norm_eps)
                    x = x + _cross_decode(lp["xattn"], cfg, a,
                                          cache["xk"][i], cache["xv"][i])
                x, _ = tfm.ffn_residual(lp, cfg, x)
                i += 1
        return x

    def _sublayer_decode(self, sub, cache, x, index: int, j: int,
                         i: int) -> torch.Tensor:
        """Sublayer i of hybrid period j, one token."""
        cfg = self.cfg
        a = apply_norm(sub["ln1"], x, cfg.norm_eps)
        if "attn" in sub:
            a, _, _ = attn.gqa_decode(
                sub["attn"], cfg, a, constrain_cache(cache["k"][j], "kv"),
                constrain_cache(cache["v"][j], "kv"), index,
                window=cfg.sliding_window)
        else:
            a, _ = ssm_lib.ssm_decode(sub["ssm"], cfg, a, {
                "state": constrain_cache(cache[f"state{i}"][j], "state"),
                "conv": constrain_cache(cache[f"conv{i}"][j], "conv")})
        x, _ = tfm.ffn_residual(sub, cfg, x + a)
        return x

    # -------------------------------------------- cache-filling prefill
    @torch.no_grad()
    def prefill_with_cache(self, batch, cache_len: int):
        """Sequential prefill (a loop of decode steps), as the reference's
        serving example runs it; the parallel forward is
        ``prefill_logits``.  An encoder-decoder first runs its encoder and
        projects every layer's cross K/V into the cache (``xk``/``xv``,
        enc_len rows)."""
        cfg = self.cfg
        tokens = self._tokens(batch["tokens"])
        B, S = tokens.shape
        if cfg.is_encoder_decoder:
            enc = self.encode(batch)
            cache = self.init_cache(B, cache_len, enc_len=enc.shape[1])
            pos = torch.arange(enc.shape[1], dtype=torch.int32,
                               device=self.device)
            stack = self.params["decoder"]["layers"]
            for i in range(tfm.depth(stack)):
                k, v = attn.gqa_project_kv(tfm.layer(stack, i)["xattn"], enc,
                                           pos, cfg.rope_theta)
                cache["xk"][i].copy_(k)
                cache["xv"][i].copy_(v)
        else:
            cache = self.init_cache(B, cache_len)
        logits = torch.zeros((B, self.cfg.padded_vocab), dtype=torch.float32,
                             device=self.device)
        for t in range(S):
            logits, cache = self.decode_step(cache, tokens[:, t:t + 1])
        return logits, cache


def _cross_decode(p, cfg: ArchConfig, x: torch.Tensor, xk: torch.Tensor,
                  xv: torch.Tensor) -> torch.Tensor:
    """One token's cross-attention over the encoder's K/V xk/xv (B,
    enc_len, KV, hd): every row attended, no padding (the reference's
    ``_cross_decode``)."""
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = attn._proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    qg = unflatten(q[:, 0], 1, (KV, H // KV)).float() / math.sqrt(hd)
    s = torch.einsum("bkgh,bckh->bkgc", qg, xk.float())
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgc,bckh->bkgh", w, xv.float())
    return attn._out(o.reshape(B, 1, H, hd).to(x.dtype), p["wo"])


class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` over the last dim, spelled in the ops of its
    composite forward (max, inf max -> 0, exp, sum, log, add) and its
    backward formula, so that its bits are the same: on a DTensor whose
    vocab is sharded over the model axis it reduces as partial max and
    sum, which DTensor's ``logsumexp`` does not."""

    @staticmethod
    def forward(ctx, x):
        m = x.amax(-1, keepdim=True)
        m = torch.where(m.abs() == math.inf, 0.0, m)
        out = (x - m).exp().sum(-1).log() + m[..., 0]
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g[..., None] * (x - out[..., None]).exp()


def _pick(logits: torch.Tensor, labels: torch.Tensor,
          lo: int = 0) -> torch.Tensor:
    """``logits[..., label - lo]`` where the label falls in the vocab
    slice [lo, lo + V) that ``logits`` holds, else 0."""
    idx = labels - lo
    v = logits.shape[-1]
    t = logits.gather(-1, idx.clamp(0, v - 1)[..., None])[..., 0]
    return torch.where((idx >= 0) & (idx < v), t, 0.0)


def _label_logits(logits: torch.Tensor, labels: torch.Tensor):
    """The label's logit of each position.  Logits whose vocab is sharded
    (a DTensor) are picked on each rank's shard through ``local_map``
    (DTensor takes no gather over a sharded dim): a partial sum over the
    shards, exact since one shard holds the label."""
    if not is_dtensor(logits):
        return _pick(logits, labels)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    v_dim = Shard(logits.dim() - 1)
    pl = list(logits.placements)
    lo, v = 0, logits.shape[-1]
    for j, q in enumerate(pl):                    # major to minor
        if q == v_dim:
            v //= mesh.size(j)
            lo += mesh.get_local_rank(j) * v
    rows = [q if q == Shard(0) else Replicate() for q in pl]
    return local_map(functools.partial(_pick, lo=lo),
                     out_placements=[Partial() if q == v_dim else r
                                     for q, r in zip(pl, rows)],
                     in_placements=(pl, rows), device_mesh=mesh,
                     redistribute_inputs=True)(logits, labels)


def _ce_chunk(emb_params, h: torch.Tensor, labels: torch.Tensor):
    """(sum of -log p(label), labels counted) over one chunk of positions,
    from its float32 logits; label -1 counts nothing.  Under sharding
    rules the logits are pinned (dp, None, tp) as in the reference."""
    h = constrain(h, ("dp", None, None))
    logits = constrain(logits_from(emb_params, h).float(),
                       ("dp", None, "tp"))
    logz = _LogSumExp.apply(logits)
    tgt = _label_logits(logits, constrain(labels.clamp_min(0),
                                          ("dp", None)))
    mask = (labels >= 0).float()
    return ((logz - tgt) * mask).sum(), mask.sum()


def _chunked_ce(emb_params, h: torch.Tensor, labels: torch.Tensor,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy with the (B, S, V) logits made only ``chunk``
    positions at a time (S padded to a multiple of it, labels with -1),
    the chunks summed in order.  Under autograd each chunk is
    checkpointed (the reference's ``nothing_saveable``): its logits are
    dropped after the forward and made again in the backward, so the
    whole (B, S, V) logits never exist in either pass."""
    B, S, _ = h.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    one = functools.partial(_ce_chunk, emb_params)
    if torch.is_grad_enabled():
        ctx = checkpoint_context_fn()
        kw = {} if ctx is None else {"context_fn": ctx}
        one = functools.partial(checkpoint, one, use_reentrant=False, **kw)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, h.shape[1], chunk):
        l, c = one(h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk])
        tot, cnt = tot + l, cnt + c
    return tot, cnt
