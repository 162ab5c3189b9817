"""The flash attention backward's plain versions and the gradients of the
port's ``chunked_attention``, on the CPU.

``flash_attention_bwd_plain`` (the explicit formula the backward kernels
compute) against ``torch.autograd`` of ``flash_attention_plain``; the LSE
of ``flash_attention_fwd_lse_plain`` against a direct log-sum-exp of the
masked scores; ``FlashAttentionFn`` on CPU tensors (its plain forward and
backward) against autograd; and ``chunked_attention``'s gradients (the
CPU route: autograd through the chunked scan) against ``jax.grad`` of the
reference's ``chunked_attention``.  Masks: causal, sliding window,
prefix-LM, and full with Sq != Sk over keys the call pads to the chunk;
GQA (4 query heads on 2 KV heads, head_dim 32) and MLA's (192, 128) pair.
The plain versions run 16 keys at a time (``PLAIN_CHUNK`` patched), so
every case crosses chunks.  Float32 throughout; the bar is 1e-5
(observed: about 2e-6 on gradients of magnitude ~1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import chunked_attention as jax_chunked
from repro_torch.kernels import attention as port_attn
from repro_torch.models.attention import chunked_attention

TOL = 1e-5
# (name, Sq, Sk, kwargs); a full call's Sk = 53 is padded to 64 keys by
# chunked_attention at chunk 32
MASKS = [("causal", 40, 40, dict(causal=True)),
         ("window", 40, 40, dict(causal=True, window=11)),
         ("prefix", 40, 40, dict(causal=True, prefix=13)),
         ("full", 30, 53, dict(causal=False))]
# (H, KV, d, dv)
HEADS = {"gqa": (4, 2, 32, 32), "mla": (2, 2, 192, 128)}


def _inputs(seed, B, Sq, Sk, H, KV, d, dv):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, d)), rng.normal(size=(B, Sk, KV, d)),
            rng.normal(size=(B, Sk, KV, dv)), rng.normal(size=(B, Sq, H, dv)))


def _t(a, grad=False):
    return torch.as_tensor(a, dtype=torch.float32).requires_grad_(grad)


@pytest.fixture
def small_chunk(monkeypatch):
    monkeypatch.setattr(port_attn, "PLAIN_CHUNK", 16)


def _case(mask, heads):
    name, Sq, Sk, kw = next(m for m in MASKS if m[0] == mask)
    H, KV, d, dv = HEADS[heads]
    seed = Sq * 7 + Sk + d + len(mask)
    return _inputs(seed, 2, Sq, Sk, H, KV, d, dv), kw


def _plain_kw(kw):
    return dict(causal=kw["causal"], window=kw.get("window", 0),
                prefix=kw.get("prefix", 0))


@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("mask", [m[0] for m in MASKS])
def test_bwd_plain_equals_autograd_of_the_plain_forward(small_chunk, mask,
                                                        heads):
    (q, k, v, do), kw = _case(mask, heads)
    kw = _plain_kw(kw)
    tq, tk, tv = (_t(a, True) for a in (q, k, v))
    out = port_attn.flash_attention_plain(tq, tk, tv, **kw)
    want = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    o, lse = port_attn.flash_attention_fwd_lse_plain(
        *(t.detach() for t in (tq, tk, tv)), **kw)
    assert torch.equal(o, out.detach())
    got = port_attn.flash_attention_bwd_plain(
        *(t.detach() for t in (tq, tk, tv)), o, lse, _t(do), **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("mask", [m[0] for m in MASKS])
def test_lse_is_the_log_sum_exp_of_the_masked_scores(small_chunk, mask,
                                                     heads):
    (q, k, v, _), kw = _case(mask, heads)
    kw = _plain_kw(kw)
    _, lse = port_attn.flash_attention_fwd_lse_plain(_t(q), _t(k), _t(v),
                                                     **kw)
    B, Sq, H, d = q.shape
    KV = k.shape[2]
    kk = np.repeat(k, H // KV, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, kk) / np.sqrt(d)
    msk = port_attn.mask(torch.arange(Sq), torch.arange(k.shape[1]),
                         causal=kw["causal"], window=kw["window"],
                         prefix_len=kw["prefix"] or None).numpy()
    s = np.where(msk[None, None], s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mask", [m[0] for m in MASKS])
def test_autograd_function_on_the_cpu_is_the_plain_pair(small_chunk, mask):
    """``FlashAttentionFn`` on CPU tensors: the plain forward's output and
    the plain backward's gradients, equal to autograd of the plain
    forward."""
    (q, k, v, do), kw = _case(mask, "gqa")
    kw = _plain_kw(kw)
    a = [_t(x, True) for x in (q, k, v)]
    b = [_t(x, True) for x in (q, k, v)]
    out = port_attn.FlashAttentionFn.apply(*a, kw["causal"], kw["window"],
                                           None, kw["prefix"])
    ref = port_attn.flash_attention_plain(*b, **kw)
    assert torch.equal(out.detach(), ref.detach())
    got = torch.autograd.grad(out, a, _t(do))
    want = torch.autograd.grad(ref, b, _t(do))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("mask", [m[0] for m in MASKS])
def test_chunked_attention_grads_match_jax_grad(mask, heads):
    """The model-level entry on the CPU (autograd through the chunked
    scan, a full call's keys padded to the chunk by ``torch.cat``) against
    ``jax.grad`` of the reference's scan, which pads with ``jnp.pad``."""
    (q, k, v, do), kw = _case(mask, heads)
    Sq, Sk = q.shape[1], k.shape[1]
    scale = float(1.0 / np.sqrt(q.shape[3]))
    prefix = kw.get("prefix")
    args = dict(causal=kw["causal"], window=kw.get("window", 0),
                prefix_len=prefix, chunk=32, scale=scale)

    def ref_loss(q, k, v):
        o = jax_chunked(q, k, v, jnp.arange(Sq, dtype=jnp.int32),
                        jnp.arange(Sk, dtype=jnp.int32), **args)
        return jnp.sum(o * jnp.asarray(do, jnp.float32))

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jnp.float32) for a in (q, k, v)))
    tq, tk, tv = (_t(a, True) for a in (q, k, v))
    pos = torch.arange(Sq, dtype=torch.int32)
    k_pos = pos if kw["causal"] else torch.arange(Sk, dtype=torch.int32)
    out = chunked_attention(tq, tk, tv, pos, k_pos, **args)
    got = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
