"""Flash attention: causal / sliding-window / prefix-LM / full, self- or
cross-attention, online softmax.

Replaces ``repro/kernels/attention.py::_flash_kernel`` (Pallas, TPU).  For
each query row it computes ``softmax(q.k^T * scale + mask) . v`` with the
softmax state (running max m, sum l, accumulator acc) in float32 and the
output ``acc / max(l, 1e-30)``.  ``scale`` is the caller's, ``d^-1/2`` by
default; v may have its own head_dim ``dv`` (MLA's prefill: d = 192 =
nope + rope, dv = 128, scale ``192^-1/2``).  The plain version and the
float32 kernel cast q to float32 and scale it before the dot, as the
reference does; the bf16 kernel scales the float32 dot instead (f32
rounding apart, the same).  Query i and key j are positions i and j; key
j is attended when ``j < prefix`` (prefix-LM: full attention inside the
prefix) or, for a causal call, ``i >= j`` with an optional window ``i - j
< window``, and always in a full call: the reference's ``_mask``.

Layout: the model's own, q (B, Sq, H, d), k (B, Sk, KV, d) and v (B, Sk,
KV, dv) with ``H % KV == 0``; query head h reads KV head ``h // (H //
KV)`` in place, where the reference's ``ops.flash_attention_op``
materialised a ``jnp.repeat`` of k and v.  Sq and Sk differ only in a
full (non-causal) call: cross-attention, or an encoder over keys padded
to the reference's chunk (``models.attention.chunked_attention``).

On a CUDA tensor :func:`flash_attention` launches ``csrc/flash_attn.cu``
and raises on what it does not take.  bfloat16 runs on the tensor cores
(``wgmma`` fed by TMA, 128-row query tiles, 64 at (256, 256); P is split
into two bf16 parts for P.V, so the output stays within one bf16 ulp of
the plain version); float32 runs on the CUDA cores (64-row query tiles,
float32 FMAs).  Both skip KV tiles that no row of a query tile attends.
What the kernel does not take: a (d, dv) pair other than (64, 64), (120,
120), (128, 128), (192, 128) or (256, 256), a causal call with Sq != Sk,
mixed dtypes, a non-contiguous tensor.  On a CPU tensor it runs
:func:`flash_attention_plain`, the port of the reference model's chunked
online-softmax scan (``repro/models/attention.py::chunked_attention``)
over exactly the keys given, whose general form :func:`chunked_scan` is
also the CPU path of ``repro_torch.models.attention.chunked_attention``.

The backward (training) is :class:`FlashAttentionFn`, which
:func:`flash_attention` takes when autograd records and q, k or v
requires grad: its forward launches the kernel with each row's
log-sum-exp (``lse`` (B, H, Sq) float32, m + log(max(l, 1e-30)) of the
scaled scores) and saves q, k, v, O and LSE; its backward is
:func:`flash_attention_bwd`, three kernels of ``csrc/flash_attn_bwd.cu``
(D = rowsum(dO * O), then dK/dV one block a KV tile, then dQ one block a
query tile; FlashAttention-2's backward without atomics, so a rerun
gives the same bits).  Two routes, by pair and dtype: bfloat16 at (64,
64), (120, 120), (128, 128) and (192, 128) runs on the tensor cores
(``wgmma`` fed by TMA, P and dS rounded once to bf16 for their products;
counted also in ``bwd_tc_launches``); bfloat16 at (256, 256), whose dK
and dV accumulators do not fit a warpgroup's registers, and float32 run
float32 FMAs on the CUDA cores.  :func:`flash_attention_bwd_cuda_cores`
runs the CUDA-core kernels at any pair: the baseline the tensor-core
kernels are timed against, on no model path.  No TPU kernel is replaced:
the reference's Pallas kernel has no backward and the reference
differentiates its jnp scan.  Their plain versions are
:func:`flash_attention_fwd_lse_plain` and :func:`flash_attention_bwd_plain`
(the explicit formula, ``PLAIN_CHUNK`` keys at a time).  Without grad the
forward-only launch runs, as it did before the backward existed.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -2.0e38            # the reference scan's masked score
# the kernel's instantiations, (q/k head_dim, v head_dim)
HEAD_DIM_PAIRS = ((64, 64), (120, 120), (128, 128), (192, 128), (256, 256))
# the plain version's KV chunk, the reference's: its (B, S, KV, g, chunk)
# float32 score block is 1.6 GB at S = 32,768
PLAIN_CHUNK = 1024
launches = 0
bwd_launches = 0             # flash_attention_bwd calls: 3 kernels each
bwd_tc_launches = 0          # ... of them on the tensor-core route

_SIG = {"flash_attn_fwd": (_build.P,) * 5 + (_build.I64,) * 10
        + (_build.F64, _build.I64, _build.P),
        "flash_attn_smem_bytes": (_build.I64,) * 3}
_BWD_ARGS = (_build.I64,) * 10 + (_build.F64, _build.I64, _build.P)
_BWD_SIG = {"flash_attn_bwd_dot": (_build.P,) * 3 + (_build.I64,) * 5
            + (_build.P,),
            "flash_attn_bwd_dkdv": (_build.P,) * 9 + _BWD_ARGS,
            "flash_attn_bwd_dq": (_build.P,) * 7 + _BWD_ARGS,
            "flash_attn_bwd_cuda_cores": (_build.P,) * 9 + _BWD_ARGS}


def no_dtensor(where: str, *ts) -> None:
    """Raise on a DTensor: a kernel wrapper takes local tensors only.
    A sharded caller runs it on each rank's shard through ``local_map``
    (``repro_torch.models.attention.chunked_attention``); no DTensor
    falls back to the plain version."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in ts):
        raise TypeError(f"{where}: a DTensor reached the kernel wrapper; "
                        "run it on local shards through local_map")


def mask(q_pos, k_pos, *, causal: bool, window: int, prefix_len):
    """(..., Sq, Sk) boolean mask. True = attend."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    if causal:
        m = qp >= kp
    else:
        m = torch.ones(q_pos.shape[:-1] + (q_pos.shape[-1], k_pos.shape[-1]),
                       dtype=torch.bool, device=q_pos.device)
    if window > 0:
        m = m & ((qp - kp) < window)
    if prefix_len is not None:
        pl = prefix_len[..., None, None] if torch.is_tensor(prefix_len) \
            and prefix_len.dim() > 0 else prefix_len
        m = m | (kp < pl)        # full attention inside the prefix
    return m


def chunked_scan(q, k, v, q_pos, k_pos, *, causal: bool, window: int = 0,
                 prefix_len=None, chunk: int = 1024,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention, a loop over KV chunks (plain torch).

    q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd).  Returns (B, Sq, H, hdv).
    The last chunk is sliced short, so exactly the keys given are
    attended; the reference's padded last chunk is the caller's
    (``repro_torch.models.attention.chunked_attention``).
    """
    no_dtensor("chunked_scan", q, k, v)
    B, Sq, H, _ = q.shape
    o_run, l_run, _ = _online_softmax(q, k, v, q_pos, k_pos, causal=causal,
                                      window=window, prefix_len=prefix_len,
                                      chunk=chunk, scale=scale)
    o = o_run / l_run.clamp_min(1e-37)[..., None]
    return o.reshape(B, Sq, H, v.shape[3]).to(q.dtype)


def _online_softmax(q, k, v, q_pos, k_pos, *, causal: bool, window: int,
                    prefix_len, chunk: int, scale: Optional[float]):
    """The chunked scan's float32 state after the last chunk: the
    unnormalised output (B, Sq, KV, g, hdv), the sum l and the running max
    m of the scaled scores (B, Sq, KV, g)."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, hdv = v.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    groups = H // KV
    qg = q.reshape(B, Sq, KV, groups, hd).float() * scale
    chunk = min(chunk, Sk)
    m_run = torch.full((B, Sq, KV, groups), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros_like(m_run)
    o_run = torch.zeros((B, Sq, KV, groups, hdv), dtype=torch.float32,
                        device=q.device)
    for c0 in range(0, Sk, chunk):
        k_i = k[:, c0:c0 + chunk].float()
        v_i = v[:, c0:c0 + chunk].float()
        s = torch.einsum("bqkgh,bckh->bqkgc", qg, k_i)
        msk = mask(q_pos, k_pos[c0:c0 + chunk], causal=causal,
                   window=window, prefix_len=prefix_len)   # (Sq, chunk)
        s = torch.where(msk[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(-1)
        o_run = o_run * corr[..., None] + torch.einsum(
            "bqkgc,bckh->bqkgh", p, v_i)
        m_run = m_new
    return o_run, l_run, m_run


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: Optional[float] = None,
                          prefix: int = 0) -> torch.Tensor:
    """Plain torch version of the kernel: the chunked scan over query
    positions 0..Sq-1 and key positions 0..Sk-1 (any device),
    ``PLAIN_CHUNK`` keys at a time."""
    dev = q.device
    return chunked_scan(q, k, v, torch.arange(q.shape[1], device=dev),
                        torch.arange(k.shape[1], device=dev), causal=causal,
                        window=window, prefix_len=prefix or None,
                        chunk=PLAIN_CHUNK, scale=scale)


def flash_attention_fwd_lse_plain(q, k, v, *, causal: bool = True,
                                  window: int = 0,
                                  scale: Optional[float] = None,
                                  prefix: int = 0):
    """Plain version of the kernel's forward with ``lse``: (the output of
    :func:`flash_attention_plain`, each row's log-sum-exp (B, H, Sq)
    float32, m + log(max(l, 1e-30)) of the scaled scores)."""
    B, Sq, H, _ = q.shape
    dev = q.device
    o_run, l_run, m_run = _online_softmax(
        q, k, v, torch.arange(Sq, device=dev),
        torch.arange(k.shape[1], device=dev), causal=causal, window=window,
        prefix_len=prefix or None, chunk=PLAIN_CHUNK, scale=scale)
    o = o_run / l_run.clamp_min(1e-37)[..., None]
    lse = m_run + torch.log(l_run.clamp_min(1e-30))
    return (o.reshape(B, Sq, H, v.shape[3]).to(q.dtype),
            lse.reshape(B, Sq, H).transpose(1, 2).contiguous())


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: int = 0,
                              scale: Optional[float] = None,
                              prefix: int = 0):
    """Plain version of the backward kernels: (dq, dk, dv) in the inputs'
    dtypes from the forward's output ``o``, its ``lse`` (B, H, Sq) and the
    output's gradient ``do``, by the explicit formula in float32,
    ``PLAIN_CHUNK`` keys at a time: D = rowsum(dO * O), P = exp(scale *
    q k^T - LSE) masked, dV = P^T dO, dS = P * (dO v^T - D), dQ = scale *
    dS k, dK = scale * dS^T q; GQA's query heads summed into their KV
    head."""
    B, Sq, H, d = q.shape
    _, Sk, KV, dv = v.shape
    g = H // KV
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    dev = q.device
    qf = q.float().reshape(B, Sq, KV, g, d)
    dof = do.float().reshape(B, Sq, KV, g, dv)
    D = (dof * o.float().reshape(B, Sq, KV, g, dv)).sum(-1)
    L = lse.float().transpose(1, 2).reshape(B, Sq, KV, g)
    q_pos, k_pos = torch.arange(Sq, device=dev), torch.arange(Sk, device=dev)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for c0 in range(0, Sk, PLAIN_CHUNK):
        k_i = k[:, c0:c0 + PLAIN_CHUNK].float()
        v_i = v[:, c0:c0 + PLAIN_CHUNK].float()
        msk = mask(q_pos, k_pos[c0:c0 + PLAIN_CHUNK], causal=causal,
                   window=window, prefix_len=prefix or None)
        s = torch.einsum("bqkgh,bckh->bqkgc", qf, k_i) * scale
        p = torch.where(msk[None, :, None, None, :],
                        torch.exp(s - L[..., None]), 0.0)
        dvs.append(torch.einsum("bqkgc,bqkgh->bckh", p, dof))
        ds = p * (torch.einsum("bqkgh,bckh->bqkgc", dof, v_i)
                  - D[..., None])
        dq += torch.einsum("bqkgc,bckh->bqkgh", ds, k_i)
        dks.append(torch.einsum("bqkgc,bqkgh->bckh", ds, qf))
    return ((dq * scale).reshape(B, Sq, H, d).to(q.dtype),
            (torch.cat(dks, dim=1) * scale).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


def _check(q, k, v, causal: bool = True) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError("flash_attention: q (B, Sq, H, d), k (B, Sk, KV, "
                         "d) and v (B, Sk, KV, dv)")
    B, Sq, H, d = q.shape
    Sk = k.shape[1]
    if k.shape[0] != B or k.shape[3] != d or Sk < 1:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if causal and Sk != Sq:
        raise ValueError(f"flash_attention: a causal call takes Sq == Sk "
                         f"(got {Sq} queries over {Sk} keys)")
    KV = k.shape[2]
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: H={H} is not a multiple of "
                         f"KV={KV}")
    if B * H > 65535:
        raise ValueError(f"flash_attention: B*H={B * H} exceeds the "
                         "kernel's grid (65535)")
    if (d, v.shape[3]) not in HEAD_DIM_PAIRS:
        raise ValueError(f"flash_attention kernel takes (q/k head_dim, v "
                         f"head_dim) in {HEAD_DIM_PAIRS}, got "
                         f"{(d, v.shape[3])}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v must share one dtype, "
                         f"float32 or bfloat16 (got {q.dtype}, {k.dtype}, "
                         f"{v.dtype})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"on {q.device}")


def _check_bwd(q, v, o, lse, do) -> None:
    B, Sq, H, _ = q.shape
    if tuple(o.shape) != (B, Sq, H, v.shape[3]) or do.shape != o.shape:
        raise ValueError(f"flash_attention_bwd: o and do must be (B, Sq, H, "
                         f"dv) = {(B, Sq, H, v.shape[3])} (got "
                         f"{tuple(o.shape)}, {tuple(do.shape)})")
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be float32 (B, H, "
                         f"Sq) = {(B, H, Sq)} (got {tuple(lse.shape)} "
                         f"{lse.dtype})")
    for name, t in (("o", o), ("do", do), ("lse", lse)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             f"contiguous on {q.device}")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o and do must be {q.dtype} "
                         f"(got {o.dtype}, {do.dtype})")


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None, prefix: int = 0,
                        want_lse: bool = False):
    """One launch of the forward kernel on CUDA tensors: (o, each row's
    log-sum-exp (B, H, Sq) float32 with ``want_lse``, else None)."""
    global launches
    prefix = max(int(prefix), 0)
    _check(q, k, v, causal)
    B, Sq, H, d = q.shape
    Sk = k.shape[1]
    dv = v.shape[3]
    o = q.new_empty((B, Sq, H, dv))
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if want_lse else None
    if o.numel() == 0:
        return o, lse
    lib = _build.load("flash_attn", _SIG)
    err = lib.flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if want_lse else None, B, Sq, Sk, H, k.shape[2], d,
        dv, int(bool(causal)), max(int(window), 0), min(prefix, Sk),
        1.0 / math.sqrt(d) if scale is None else float(scale),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    _build.check(err, "flash_attention")
    launches += 1
    return o, lse


def _bwd_launch(q, k, v, o, lse, do, causal, window, scale, prefix,
                cuda_cores: bool):
    """The backward's launches on CUDA tensors: D, then dK/dV and dQ by
    the route of the pair and dtype, or on the CUDA cores with
    ``cuda_cores``.  (dq, dk, dv, 1 if the tensor-core kernels ran, as
    the dK/dV launch reports it)."""
    _check(q, k, v, causal)
    _check_bwd(q, v, o, lse, do)
    B, Sq, H, d = q.shape
    Sk, KV, dv = k.shape[1], k.shape[2], v.shape[3]
    dq, dk, dvv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dvv, 0
    lib = _build.load("flash_attn_bwd", _BWD_SIG)
    bf16 = int(q.dtype == torch.bfloat16)
    D = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    st = _build.stream_ptr(q.device)
    _build.check(lib.flash_attn_bwd_dot(o.data_ptr(), do.data_ptr(),
                                        D.data_ptr(), B, Sq, H, dv, bf16, st),
                 "flash_attention_bwd (dot)")
    args = (B, Sq, Sk, H, KV, d, dv, int(bool(causal)), max(int(window), 0),
            min(prefix, Sk),
            1.0 / math.sqrt(d) if scale is None else float(scale), bf16, st)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), D.data_ptr())
    if cuda_cores:
        _build.check(lib.flash_attn_bwd_cuda_cores(
            *common, dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(), *args),
            "flash_attention_bwd_cuda_cores")
        return dq, dk, dvv, 0
    tc = ctypes.c_int32(0)
    _build.check(lib.flash_attn_bwd_dkdv(*common, dk.data_ptr(),
                                         dvv.data_ptr(),
                                         ctypes.addressof(tc), *args),
                 "flash_attention_bwd (dkdv)")
    _build.check(lib.flash_attn_bwd_dq(*common, dq.data_ptr(), *args),
                 "flash_attention_bwd (dq)")
    return dq, dk, dvv, tc.value


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, scale: Optional[float] = None,
                        prefix: int = 0):
    """(dq, dk, dv) of the attention that gave ``o`` and ``lse`` (the
    forward's, same arguments) for the output gradient ``do``.  On a CUDA
    tensor three launches of ``csrc/flash_attn_bwd.cu`` (D, then dK/dV,
    then dQ: on the tensor cores for bf16 at (64, 64), (120, 120), (128,
    128) and (192, 128), else on the CUDA cores), counted once in
    ``bwd_launches`` and, on the tensor cores, in ``bwd_tc_launches``; it
    raises on what the forward does not take (and, on the tensor cores, on
    a tensor that is not 16-byte aligned).  On a CPU tensor
    :func:`flash_attention_bwd_plain`."""
    global bwd_launches, bwd_tc_launches
    prefix = max(int(prefix), 0)
    if q.device.type != "cuda":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window, scale=scale,
                                         prefix=prefix)
    dq, dk, dv, tc = _bwd_launch(q, k, v, o, lse, do, causal, window, scale,
                                 prefix, cuda_cores=False)
    if q.numel():
        bwd_launches += 1
        bwd_tc_launches += tc
    return dq, dk, dv


def flash_attention_bwd_cuda_cores(q, k, v, o, lse, do, *,
                                   causal: bool = True, window: int = 0,
                                   scale: Optional[float] = None,
                                   prefix: int = 0):
    """:func:`flash_attention_bwd` on the CUDA-core kernels at any pair
    and dtype (CUDA tensors only): the bf16 route the tensor-core kernels
    replaced, kept as the baseline they are timed against; no model path
    calls it, and no counter counts it."""
    if q.device.type != "cuda":
        raise ValueError("flash_attention_bwd_cuda_cores: CUDA tensors only")
    dq, dk, dv, _ = _bwd_launch(q, k, v, o, lse, do, causal, window, scale,
                                max(int(prefix), 0), cuda_cores=True)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its gradient: the forward kernel with ``lse``
    (q, k, v, O and LSE saved), the backward kernels for dq, dk, dv.  On
    CPU tensors the two plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, prefix):
        no_dtensor("FlashAttentionFn", q, k, v)
        kw = dict(causal=causal, window=window, scale=scale, prefix=prefix)
        if q.device.type == "cuda":
            o, lse = flash_attention_fwd(q, k, v, want_lse=True, **kw)
        else:
            o, lse = flash_attention_fwd_lse_plain(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    prefix: int = 0) -> torch.Tensor:
    """Attention of q (B, Sq, H, d) over k (B, Sk, KV, d) and v (B, Sk,
    KV, dv), scores scaled by ``scale`` (``d^-1/2`` when None), keys below
    ``prefix`` attended by every query; (B, Sq, H, dv).  On CUDA with grad
    recorded for q, k or v: :class:`FlashAttentionFn`; otherwise one
    forward-only launch."""
    no_dtensor("flash_attention", q, k, v)
    prefix = max(int(prefix), 0)
    if q.device.type != "cuda":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, prefix=prefix)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, scale, prefix)
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               scale=scale, prefix=prefix)[0]
