"""The port's flash attention (plain version on the CPU) against the JAX
reference's Pallas kernel, its oracle and its model-level chunked scan.

Same numpy-seeded inputs through both.  Tolerances are the reference's
own (``tests/test_kernels.py``): 2e-3 in float32, 2e-2 in bfloat16.  The
last test holds ``chip_smoke.py``'s bar for the kernel on the card to
what it must catch.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref
from repro.kernels.ops import flash_attention_op as jax_flash_op
from repro.models.attention import chunked_attention as jax_chunked
from repro_torch.kernels import attention as port_attn
from repro_torch.kernels.ops import flash_attention_op
from repro_torch.models.attention import chunked_attention

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(rng, B, S, H, KV, d):
    return (rng.normal(size=(B, S, H, d)), rng.normal(size=(B, S, KV, d)),
            rng.normal(size=(B, S, KV, d)))


def _np32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("S,blk", [(128, 64), (256, 128)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_plain_matches_reference_kernel(S, blk, causal, window, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    B, H, KV, d = 2, 4, 2, 64
    q, k, v = _qkv(np.random.default_rng(S + window), B, S, H, KV, d)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tq, tk, tv = (torch.as_tensor(a, dtype=torch.float32).to(tdt)
                  for a in (q, k, v))
    want = jax_flash_op(jq, jk, jv, causal=causal, window=window,
                        block_q=blk, block_k=blk)
    kx, vx = (jnp.repeat(a, H // KV, axis=2) for a in (jk, jv))
    fold = (lambda a: a.transpose(0, 2, 1, 3).reshape(B * H, S, d))
    oracle = ref.attention_ref(fold(jq), fold(kx), fold(vx), causal=causal,
                               window=window)
    oracle = _np32(oracle).reshape(B, H, S, d).transpose(0, 2, 1, 3)
    plain = port_attn.flash_attention_plain(tq, tk, tv, causal=causal,
                                            window=window)
    op = flash_attention_op(tq, tk, tv, causal=causal, window=window)
    assert plain.dtype == tdt and op.dtype == tdt
    for got in (plain, op):
        np.testing.assert_allclose(_np32(got), _np32(want), rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(_np32(got), oracle, rtol=tol, atol=tol)


@pytest.mark.parametrize("S,chunk,window,prefix", [
    (128, 32, 0, None), (128, 32, 48, None), (100, 32, 0, None),
    (128, 64, 0, 40)])
def test_chunked_attention_matches_reference_scan(S, chunk, window, prefix):
    """The port's chunked scan (the CPU path of ``chunked_attention``) ==
    the reference's, in float32: causal, windowed, a ragged last chunk
    (masked by causality) and a prefix-LM prefix.  2e-3, the reference's
    bar between its kernel and this scan."""
    B, H, KV, d = 2, 4, 2, 32
    q, k, v = _qkv(np.random.default_rng(S + chunk), B, S, H, KV, d)
    pos = np.arange(S)
    want = jax_chunked(*(jnp.asarray(a, jnp.float32) for a in (q, k, v)),
                       jnp.asarray(pos), jnp.asarray(pos), causal=True,
                       window=window, prefix_len=prefix, chunk=chunk)
    tpos = torch.as_tensor(pos)
    got = chunked_attention(*(torch.as_tensor(a, dtype=torch.float32)
                              for a in (q, k, v)), tpos, tpos, causal=True,
                            window=window, prefix_len=prefix, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("S,H", [(96, 4), (130, 2)])
def test_flash_plain_takes_hdv_and_scale(S, H, dtype):
    """MLA's call shape: q/k head_dim 192, v head_dim 128, and a scale
    given by the caller (0.9 / sqrt(192) here, not the default 1/sqrt(192),
    so a dropped scale shows).  ``flash_attention_op`` on CPU tensors (the
    plain version) against the reference's ``chunked_attention`` with the
    same ``scale``, at the reference's tolerances."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(S + H)
    q, k = rng.normal(size=(2, 1, S, H, 192))
    v = rng.normal(size=(1, S, H, 128))
    scale = 0.9 / float(np.sqrt(192))
    pos = jnp.arange(S)
    want = jax_chunked(*(jnp.asarray(a, jdt) for a in (q, k, v)), pos, pos,
                       causal=True, scale=scale)
    got = flash_attention_op(*(torch.as_tensor(a, dtype=torch.float32)
                               .to(tdt) for a in (q, k, v)), scale=scale)
    assert got.shape == (1, S, H, 128) and got.dtype == tdt
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=tol, atol=tol)
    default = flash_attention_op(*(torch.as_tensor(a, dtype=torch.float32)
                                   for a in (q, k, v)))
    assert not np.allclose(default.numpy(), _np32(got), rtol=tol, atol=tol)


def test_cpu_tensors_launch_nothing():
    before = port_attn.launches
    q, k, v = (torch.as_tensor(a, dtype=torch.float32) for a in
               _qkv(np.random.default_rng(0), 1, 64, 4, 2, 64))
    port_attn.flash_attention(q, k, v)
    flash_attention_op(q, k, v, window=16)
    pos = torch.arange(64)
    chunked_attention(q, k, v, pos, pos, causal=True)
    assert port_attn.launches == before == 0


@pytest.mark.parametrize("case", ["head_dim", "pair_square_192",
                                  "pair_v_wider", "pair_k_not_q", "groups",
                                  "dtype", "cross", "strided"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(case):
    """The checks the wrapper makes before a launch (run here on CPU
    tensors; on the card the same checks guard the kernel): (q/k head_dim,
    v head_dim) outside the instantiated pairs, k's head_dim not q's, ...
    Each instantiated pair passes."""
    q = torch.zeros(1, 64, 4, 64)
    k = v = torch.zeros(1, 64, 2, 64)
    if case == "head_dim":
        q, k, v = q[..., :32], k[..., :32].contiguous(), \
            v[..., :32].contiguous()
        q = q.contiguous()
    elif case == "pair_square_192":
        q, k, v = torch.zeros(1, 64, 4, 192), torch.zeros(1, 64, 2, 192), \
            torch.zeros(1, 64, 2, 192)
    elif case == "pair_v_wider":
        q, k, v = torch.zeros(1, 64, 4, 128), torch.zeros(1, 64, 2, 128), \
            torch.zeros(1, 64, 2, 192)
    elif case == "pair_k_not_q":
        k = torch.zeros(1, 64, 2, 192)
        q, v = torch.zeros(1, 64, 4, 128), torch.zeros(1, 64, 2, 128)
    elif case == "groups":
        k = v = torch.zeros(1, 64, 3, 64)
    elif case == "dtype":
        k = k.to(torch.bfloat16)
    elif case == "cross":
        k = v = torch.zeros(1, 32, 2, 64)
    else:
        q = torch.zeros(1, 4, 64, 64).transpose(1, 2)
    with pytest.raises(ValueError, match="flash_attention"):
        port_attn._check(q, k, v)
    for d, dv in port_attn.HEAD_DIM_PAIRS:
        port_attn._check(torch.zeros(1, 64, 4, d), torch.zeros(1, 64, 2, d),
                         torch.zeros(1, 64, 2, dv))
    assert (192, 128) in port_attn.HEAD_DIM_PAIRS


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dense(q, k, v, allowed):
    """Attention in float32 over an explicit (S, S) mask, K/V expanded to
    every head; a row with no key left gives zeros, as the kernel does."""
    d, g = q.shape[-1], q.shape[2] // k.shape[2]
    kx, vx = (x.float().repeat_interleave(g, dim=2) for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * d ** -0.5, kx)
    p = s.masked_fill(~allowed, float("-inf")).softmax(-1).nan_to_num(0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, vx).to(q.dtype)


def _tensor_core_scan(q, k, v, split: bool, tile: int = 64):
    """The arithmetic of the bf16 tensor-core kernel (``csrc/flash_attn.cu``)
    on the CPU, causal: S = q.k^T in float32 from the operands as they
    are, then scaled; an online softmax over ``tile``-key tiles with m and
    l in float32 (l sums the unrounded p); P.V in float32 with P rounded
    to bf16 (``split=False``, FlashAttention-2's choice) or as the bf16
    parts hi = bf16(p) and lo = bf16(p - hi) (``split=True``, the
    kernel's), every product exact as on the tensor cores."""
    B, S, H, d = q.shape
    g = H // k.shape[2]
    qf = q.float()
    kf, vf = (x.float().repeat_interleave(g, dim=2) for x in (k, v))
    m = torch.full((B, H, S), float("-inf"))
    l = torch.zeros(B, H, S)
    acc = torch.zeros(B, H, S, d)
    i = torch.arange(S)
    for k0 in range(0, S, tile):
        s = torch.einsum("bqhd,bkhd->bhqk", qf,
                         kf[:, k0:k0 + tile]) * d ** -0.5
        s = s.masked_fill(i[:, None] < i[None, k0:k0 + tile],
                          float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        base = torch.where(m_new == float("-inf"), 0.0, m_new)
        p = torch.exp(s - base[..., None])
        corr = torch.exp(m - base)
        l = l * corr + p.sum(-1)
        hi = p.bfloat16().float()
        parts = (hi, (p - hi).bfloat16().float()) if split else (hi,)
        acc = acc * corr[..., None]
        for part in parts:
            acc = acc + torch.einsum("bhqk,bkhd->bhqd", part,
                                     vf[:, k0:k0 + tile])
        m = m_new
    o = acc / l.clamp_min(1e-30)[..., None]
    return o.transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("mutant", ["none", "tile_dropped",
                                    "diagonal_masked", "next_key_attended",
                                    "p_rounded_bf16", "p_split_hi_lo"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_chip_check_of_flash_catches_a_broken_kernel(mutant, dtype):
    """``chip_smoke.flash_agreement``, the bar the flash kernel is held to
    on the card: dense attention (another order of arithmetic) passes it,
    and fails it when the last 64-row query tile drops its first 64-key
    tile or the causal diagonal moves by one.  Inputs at the model's
    scale (q, k, v of std 0.78, as under the random init) and the prefill
    cell's S = 4,096, where the dropped tile moves no element by more than
    8e-3: inside the reference's fixed 2e-2 + 2e-2 |plain| bar, 155x the
    new bf16 limit.  The last two cases are the tensor-core kernel's
    arithmetic: with P rounded to bf16 before P.V it fails the bar, with
    P split into bf16 hi + lo (two products into one f32 accumulator, as
    the kernel does) it passes."""
    tdt = DTYPES[dtype][1]
    S = 4096
    q, k, v = (torch.as_tensor(0.78 * a, dtype=torch.float32).to(tdt)
               for a in _qkv(np.random.default_rng(7), 1, S, 2, 1, 128))
    want = port_attn.flash_attention_plain(q, k, v)
    if mutant.startswith("p_"):
        got = _tensor_core_scan(q, k, v, split=mutant == "p_split_hi_lo")
    else:
        i = torch.arange(S)
        allowed = i[:, None] >= i[None, :]
        if mutant == "tile_dropped":
            allowed[S - 64:, :64] = False
        elif mutant == "diagonal_masked":
            allowed = i[:, None] > i[None, :]
        elif mutant == "next_key_attended":
            allowed = i[:, None] + 1 >= i[None, :]
        got = _dense(q, k, v, allowed)
    *_, ok = _chip_smoke().flash_agreement(got, want)
    assert ok == (mutant in ("none", "p_split_hi_lo"))
