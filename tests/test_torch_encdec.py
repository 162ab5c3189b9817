"""The encoder-decoder (whisper) and VLM (paligemma) slice against the JAX
reference, on the CPU.

Same numpy-seeded inputs through both packages; the reference's smoke
parameters carried across with ``from_jax_params``.  Bars: 1e-5 in float32
(observed: a few 1e-7 on logits of magnitude ~1), two bf16 ulps of the
output's scale in bfloat16, 2e-3 for prefill against decode (the
reference's bar).  The full (non-causal) attention cases cover the
reference's padded last KV chunk, which the port matches: Sk = 1,500 is
where the scan that sliced the last chunk short was off.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.kernels.ops import flash_attention_op as jax_flash_op
from repro.models import Model as RefModel
from repro.models import transformer as ref_tfm
from repro.models.attention import chunked_attention as jax_chunked
from repro.serving import PackageScheduler as RefScheduler
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.kernels import attention as port_attn
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import chunked_attention
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import PackageScheduler, Request, ServingEngine

TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _attn_inputs(seed, B, Sq, Sk, H, KV, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, d)), rng.normal(size=(B, Sk, KV, d)),
            rng.normal(size=(B, Sk, KV, d)))


def _both(q, k, v, q_pos, k_pos, **kw):
    """(port, reference) ``chunked_attention`` in float32."""
    want = jax_chunked(*(jnp.asarray(a, jnp.float32) for a in (q, k, v)),
                       jnp.asarray(q_pos), jnp.asarray(k_pos), **kw)
    tq, tk, tv = (torch.as_tensor(a, dtype=torch.float32) for a in (q, k, v))
    qp = torch.as_tensor(q_pos)
    kp = qp if k_pos is q_pos else torch.as_tensor(k_pos)
    return chunked_attention(tq, tk, tv, qp, kp, **kw), want


@pytest.mark.parametrize("Sk", [1024, 1025, 1500, 2048])
@pytest.mark.parametrize("cross", [False, True])
def test_full_attention_matches_the_reference_padded_chunk(Sk, cross):
    """Non-causal ``chunked_attention`` (the encoder's self-attention, the
    decoder's cross-attention at Sq = 48) == the reference's at 1e-5,
    across the 1,024-key chunk: the last chunk padded with zero keys that
    a full mask attends."""
    Sq = 48 if cross else Sk
    q, k, v = _attn_inputs(Sk + Sq, 1, Sq, Sk, 4, 2, 16)
    got, want = _both(q, k, v, np.arange(Sq), np.arange(Sk), causal=False)
    _close(got, want)


def test_sliced_last_chunk_was_off_at_1500_frames():
    """The divergence the padding repairs: at Sk = 1,500 the scan over only
    the keys given (the kernel's plain version, the port's scan before
    this slice) is off the reference by far more than 1e-5, and
    ``chunked_attention``, which pads, is not."""
    q, k, v = _attn_inputs(3, 1, 48, 1500, 4, 2, 16)
    pos_q, pos_k = np.arange(48), np.arange(1500)
    got, want = _both(q, k, v, pos_q, pos_k, causal=False)
    t = [torch.as_tensor(a, dtype=torch.float32) for a in (q, k, v)]
    sliced = port_attn.chunked_scan(*t, torch.as_tensor(pos_q),
                                    torch.as_tensor(pos_k), causal=False)
    assert np.abs(sliced.numpy() - np.asarray(want)).max() > 1e-3
    _close(got, want)


@pytest.mark.parametrize("prefix", [0, 16, 256])
def test_prefix_lm_matches_the_reference(prefix):
    """Prefix-LM (causal, keys below the prefix attended by every query)
    at S = 320 == the reference, 1e-5."""
    q, k, v = _attn_inputs(prefix, 2, 320, 320, 4, 1, 32)
    pos = np.arange(320)
    got, want = _both(q, k, v, pos, pos, causal=True, prefix_len=prefix)
    _close(got, want)


@pytest.mark.parametrize("Sk,window", [(1500, 0), (2048, 0), (1500, 200)])
def test_causal_calls_unchanged_by_the_padding(Sk, window):
    """A causal call masks the padded keys: the padded scan equals the
    reference and the scan over only the keys given, 1e-5."""
    q, k, v = _attn_inputs(Sk + window, 1, Sk, Sk, 2, 1, 16)
    pos = np.arange(Sk)
    got, want = _both(q, k, v, pos, pos, causal=True, window=window)
    _close(got, want)
    t = [torch.as_tensor(a, dtype=torch.float32) for a in (q, k, v)]
    tp = torch.as_tensor(pos)
    _close(got, port_attn.chunked_scan(*t, tp, tp, causal=True,
                                       window=window))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_the_pallas_kernel(causal, dtype):
    """The kernel's plain version == the reference's Pallas kernel in
    interpret mode, causal and full self-attention at S = 192 (ragged to
    its 128-row blocks: 256 padded), head_dim 64 and 256: 1e-5 in
    float32, two bf16 ulps of the output's scale in bfloat16."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    for d, H, KV in ((64, 4, 2), (256, 2, 1)):
        q, k, v = _attn_inputs(d, 1, 256, 256, H, KV, d)
        want = jax_flash_op(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                            causal=causal, block_q=128, block_k=128)
        got = port_attn.flash_attention_plain(
            *(torch.as_tensor(a, dtype=torch.float32).to(tdt)
              for a in (q, k, v)), causal=causal)
        want = np.asarray(want, np.float32)
        tol = TOL if dtype == "float32" else 2 * 2.0 ** -7 * \
            float(np.abs(want).max())
        _close(got.float(), want, tol)


@pytest.mark.parametrize("Sq,Sk,prefix", [(48, 77, 0), (40, 300, 0),
                                          (320, 320, 16), (320, 320, 256)])
def test_flash_plain_cross_and_prefix_match_the_reference(Sq, Sk, prefix):
    """Cross-attention (full, Sq != Sk, Sk within one chunk, so the
    reference pads nothing) and prefix-LM through ``flash_attention_op``
    on CPU tensors (the plain version) == the reference's
    ``chunked_attention``, 1e-5, head_dim 64 and MQA."""
    from repro_torch.kernels.ops import flash_attention_op
    q, k, v = _attn_inputs(Sq + Sk + prefix, 2, Sq, Sk, 4, 1, 64)
    causal = Sq == Sk
    want = jax_chunked(*(jnp.asarray(a, jnp.float32) for a in (q, k, v)),
                       jnp.arange(Sq), jnp.arange(Sk), causal=causal,
                       prefix_len=prefix or None)
    got = flash_attention_op(*(torch.as_tensor(a, dtype=torch.float32)
                               for a in (q, k, v)), causal=causal,
                             prefix=prefix)
    _close(got, want)


# ----------------------------------------------------------------- models


def _pair(arch, **changes):
    ref_cfg = dataclasses.replace(ref_config(arch).smoke(),
                                  param_dtype="float32", **changes)
    cfg = dataclasses.replace(get_config(arch).smoke(),
                              param_dtype="float32", **changes)
    ref = RefModel(ref_cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = from_jax_params(jax.tree.map(np.asarray, params), cfg, "cpu")
    return ref, params, port


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, (B, S))
             .astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["enc_inputs"] = rng.normal(
            size=(B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.num_prefix_tokens:
        batch["prefix"] = rng.normal(
            size=(B, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_whisper_encoder_and_prefill_match_the_reference():
    """whisper-smoke: ``apply_encoder`` and the prefill logits, 1e-5."""
    ref, params, port = _pair("whisper-base")
    batch = _batch(port.cfg, 2, 12)
    enc = tfm.apply_encoder(port.params["encoder"], port.cfg,
                            torch.as_tensor(batch["enc_inputs"]))
    _close(enc, ref_tfm.apply_encoder(params["encoder"], ref.cfg,
                                      jnp.asarray(batch["enc_inputs"])))
    full = port.prefill_logits(batch)
    assert full.shape == (2, 12, port.cfg.padded_vocab)
    _close(full, ref.prefill_logits(params, _jax(batch)))


def test_whisper_cache_and_decode_match_the_reference():
    """whisper-smoke: ``init_cache`` shapes with and without ``enc_len``;
    ``prefill_with_cache`` (the encoder's cross K/V in the cache, then
    decode steps) and two more decode steps over that filled cross cache
    == the reference's, 1e-5; those steps against the parallel prefill
    within 2e-3."""
    ref, params, port = _pair("whisper-base")
    cfg = port.cfg
    cache = port.init_cache(2, 16, enc_len=40)
    want = ref.init_cache(2, 16, enc_len=40)
    assert set(cache) == set(want)
    for key in ("k", "v", "xk", "xv"):
        assert tuple(cache[key].shape) == want[key].shape
    assert tuple(port.init_cache(1, 8)["xk"].shape) == \
        (cfg.num_layers, 1, cfg.encoder_seq_len, cfg.num_kv_heads,
         cfg.resolved_head_dim)
    batch = _batch(cfg, 2, 12, seed=1)
    head = {**batch, "tokens": batch["tokens"][:, :10]}
    got, cache = port.prefill_with_cache(head, 16)
    want, ref_cache = ref.prefill_with_cache(params, _jax(head), 16)
    _close(got, want)
    _close(cache["xk"], ref_cache["xk"])
    _close(cache["xv"], ref_cache["xv"])
    full = port.prefill_logits(batch)
    _close(got, full[:, 9], 2e-3)
    step = jax.jit(ref.decode_step)
    for t in (10, 11):
        tok = batch["tokens"][:, t:t + 1]
        got, cache = port.decode_step(cache, tok)
        want, ref_cache = step(params, ref_cache, jnp.asarray(tok))
        _close(got, want)
        _close(got, full[:, t], 2e-3)
    assert cache["index"] == 12


def test_whisper_at_1500_frames_matches_the_reference():
    """whisper-smoke at the full encoder length (1,500 frames, narrow
    width): the prefill logits == the reference's, 1e-5.  The encoder's
    self-attention and every cross-attention attend the reference's 548
    padded keys; the step-by-step path (``prefill_with_cache`` and
    decode), which pads nothing in either package, also equals the
    reference's, and differs from the prefill by more than 1e-5."""
    ref, params, port = _pair("whisper-base", encoder_seq_len=1500)
    batch = _batch(port.cfg, 1, 6, seed=2)
    full = port.prefill_logits(batch)
    _close(full, ref.prefill_logits(params, _jax(batch)))
    got, _ = port.prefill_with_cache(batch, 8)
    want, _ = ref.prefill_with_cache(params, _jax(batch), 8)
    _close(got, want)
    assert np.abs(got.numpy() - full[:, -1].numpy()).max() > 1e-5


def test_paligemma_prefill_and_decode_match_the_reference():
    """paligemma-smoke: prefill logits with its 16-patch prefix (prefix-LM)
    == the reference's, 1e-5, and decode steps (which see no prefix, in
    the reference as in the port) == the reference's, 1e-5."""
    ref, params, port = _pair("paligemma-3b")
    cfg = port.cfg
    assert cfg.num_prefix_tokens == 16 and cfg.num_kv_heads == 1
    batch = _batch(cfg, 2, 12, seed=3)
    full = port.prefill_logits(batch)
    assert full.shape == (2, 16 + 12, cfg.padded_vocab)
    _close(full, ref.prefill_logits(params, _jax(batch)))
    step = jax.jit(ref.decode_step)
    cache, ref_cache = port.init_cache(2, 16), ref.init_cache(2, 16)
    for t in range(12):
        tok = batch["tokens"][:, t:t + 1]
        got, cache = port.decode_step(cache, tok)
        want, ref_cache = step(params, ref_cache, jnp.asarray(tok))
        _close(got, want)


@pytest.mark.parametrize("arch", ["whisper-base", "paligemma-3b"])
def test_greedy_tokens_match_the_reference(arch):
    """``generate_batch``: the same greedy tokens as the reference's
    engine (decode steps only: whisper's cross cache the zeros of
    ``init_cache``, paligemma without its prefix, as the reference's
    engine runs them)."""
    ref, params, port = _pair(arch)
    prompts = np.random.default_rng(5).integers(
        1, port.cfg.vocab_size, (3, 10)).astype(np.int32)
    want = RefEngine(ref.cfg, params, cache_len=32).generate_batch(prompts,
                                                                   8)
    got = ServingEngine(port, cache_len=32).generate_batch(prompts, 8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch,hbm_frac", [("whisper-base", 3e-3),
                                           ("paligemma-3b", 5e-3)])
def test_scheduler_admits_as_reference(arch, hbm_frac):
    """Both full configs: the same requests admitted on every tick (the
    KV budget binds: a knapsack that B&B branches on)."""
    kw = dict(hbm_budget_bytes=hbm_frac * 16 * 2**30, flop_budget=5e13,
              max_batch=8, time_limit_s=600.0)
    ref = RefScheduler(ref_config(arch), **kw)
    port = PackageScheduler(get_config(arch), device="cpu", **kw)
    rng = np.random.default_rng(0)
    for rid in range(20):
        r = dict(rid=rid, prompt_tokens=int(rng.integers(4, 2048)),
                 max_new_tokens=int(rng.integers(4, 16)),
                 priority=float(rng.uniform(0.1, 1.0)))
        ref.submit(RefRequest(**r))
        port.submit(Request(**r))
    ticks = 0
    while ref.queue or port.queue:
        want = [r.rid for r in ref.tick()]
        assert [r.rid for r in port.tick()] == want, ticks
        ticks += 1
        assert ticks < 20 and want
    assert port.admitted_total == ref.admitted_total == 20


@pytest.mark.parametrize("arch", ["whisper-base-smoke", "paligemma-3b-smoke"])
def test_launch_serve_on_cpu(arch):
    from repro_torch.launch import serve
    done = serve.main(["--arch", arch, "--device", "cpu", "--requests", "6",
                       "--ticks", "3"])
    assert sorted(g.rid for g in done) == list(range(6))
