"""The port's MLA (DeepSeek-V3's multi-head latent attention), its model
and its MTP head against the JAX reference, at ``deepseek-v3-671b-smoke``.

Inputs come from ``np.random.default_rng`` seeds; parameters are the
reference's (``init_params`` / ``Model.init`` under ``PRNGKey``) carried
across as numpy.  The reference's MLA path has no Pallas kernel, so it
runs as it is on the CPU; the port's prefill goes through the plain
version of the flash kernel here (``chunked_scan``, with MLA's q/k head
dim nope + rope, v head dim and scale).

Bars: 2e-5 for MLA in float32 (observed ~1e-6) and 1e-5 on logits (the
model tests' bar); 2e-3 for absorbed decode against expanded prefill,
the reference's own ``test_prefill_decode_logits_agree`` bar (the two
forms sum in other orders).  In bfloat16 both packages round the same
products, but XLA and torch may round a bf16 product's float32 sum at
other points (and the flash scan's float32 state is rounded once at the
end), so outputs are held to 2 bf16 ulps of the output's scale: 2^-6
relative plus 2^-6 of max |reference| absolute.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import Model as RefModel
from repro.models import attention as ref_attn
from repro.models import transformer as ref_tfm
from repro.models.layers import apply_norm as ref_apply_norm
from repro.models.layers import embed_tokens as ref_embed_tokens
from repro.models.param import init_params as ref_init_params
from repro.serving import PackageScheduler as RefScheduler
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.kernels import attention as port_kernel
from repro_torch.models import Model, attention, param as param_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import _convert, from_jax_params
from repro_torch.models.layers import apply_norm, embed_tokens
from repro_torch.serving import PackageScheduler, Request, ServingEngine

ARCH = "deepseek-v3-671b"
F32_TOL = 2e-5
LOGIT_TOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dtype="float32", **changes):
    """(reference config, port config): the smoke config in ``dtype``."""
    ref = dataclasses.replace(ref_config(ARCH).smoke(), param_dtype=dtype,
                              **changes)
    port = dataclasses.replace(get_config(ARCH).smoke(), param_dtype=dtype,
                               **changes)
    return ref, port


def _attn_params(ref_cfg, dtype, seed=1):
    """The reference's MLA parameters: (jax tree, the port's torch tree)."""
    jp = ref_init_params(ref_attn.mla_spec(ref_cfg), jax.random.PRNGKey(seed),
                         DTYPES[dtype][0])
    return jp, _convert(jax.tree.map(np.asarray, jp))


def _f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype="float32", tol=F32_TOL):
    got, want = _f32(got), _f32(want)
    if dtype == "bfloat16":
        tol = 2.0 ** -6
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _pair(**changes):
    """The reference model, its parameters and the port's model holding
    them (``from_jax_params``), float32 smoke."""
    ref_cfg, cfg = _cfgs(**changes)
    ref = RefModel(ref_cfg)
    params = ref.init(jax.random.PRNGKey(0))
    return ref, params, from_jax_params(jax.tree.map(np.asarray, params),
                                        cfg, "cpu")


def _tokens(B, S, seed, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab,
                                                (B, S)).astype(np.int32)


# ------------------------------------------------------------- the layer


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mla_forward_matches_reference(dtype):
    ref_cfg, cfg = _cfgs(dtype)
    jp, tp = _attn_params(ref_cfg, dtype)
    B, S = 2, 12
    x = np.random.default_rng(0).normal(size=(B, S, cfg.d_model))
    jx = jnp.asarray(x, DTYPES[dtype][0])
    tx = torch.as_tensor(x, dtype=torch.float32).to(DTYPES[dtype][1])
    want = ref_attn.mla_forward(jp, ref_cfg, jx, jnp.arange(S, dtype=jnp.int32))
    got = attention.mla_forward(tp, cfg, tx, torch.arange(S, dtype=torch.int32))
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, S, cfg.d_model)
    assert port_kernel.launches == 0
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mla_decode_steps_match_reference(dtype):
    """Step by step over a cache of 6 slots for 9 tokens, from the same
    caches: outputs and both caches equal the reference's after each step,
    including the steps at index >= S_cache, where the reference's
    ``dynamic_update_slice`` clamps the write to the last slot while every
    slot stays valid."""
    ref_cfg, cfg = _cfgs(dtype)
    jdt, tdt = DTYPES[dtype]
    jp, tp = _attn_params(ref_cfg, dtype, seed=2)
    B, S_cache, steps = 2, 6, 9
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(steps, B, 1, cfg.d_model))
    jc = jnp.zeros((B, S_cache, cfg.kv_lora_rank), jdt)
    jr = jnp.zeros((B, S_cache, cfg.qk_rope_head_dim), jdt)
    tc = torch.zeros(tuple(jc.shape), dtype=tdt)
    tr = torch.zeros(tuple(jr.shape), dtype=tdt)
    for t in range(steps):
        want, jc, jr = ref_attn.mla_decode(jp, ref_cfg, jnp.asarray(xs[t], jdt),
                                           jc, jr, jnp.asarray(t, jnp.int32))
        got, c2, r2 = attention.mla_decode(
            tp, cfg, torch.as_tensor(xs[t], dtype=torch.float32).to(tdt),
            tc, tr, t)
        assert c2 is tc and r2 is tr            # written in place
        _close(got, want, dtype)
        _close(tc, jc, dtype)
        _close(tr, jr, dtype)
    # the clamp: the last three tokens all went to slot S_cache - 1
    assert steps - 1 >= S_cache


def test_mla_decode_clamps_the_write_at_the_last_slot():
    """At index >= S_cache the token's latent lands in slot S_cache - 1 and
    no other slot changes, as in the reference."""
    ref_cfg, cfg = _cfgs()
    jp, tp = _attn_params(ref_cfg, "float32", seed=3)
    B, S_cache = 1, 4
    rng = np.random.default_rng(2)
    c0 = rng.normal(size=(B, S_cache, cfg.kv_lora_rank)).astype(np.float32)
    r0 = rng.normal(size=(B, S_cache, cfg.qk_rope_head_dim)).astype(np.float32)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    for index in (S_cache, S_cache + 3):
        want, jc, jr = ref_attn.mla_decode(jp, ref_cfg, jnp.asarray(x),
                                           jnp.asarray(c0), jnp.asarray(r0),
                                           jnp.asarray(index, jnp.int32))
        tc, tr = torch.from_numpy(c0.copy()), torch.from_numpy(r0.copy())
        got, _, _ = attention.mla_decode(tp, cfg, torch.from_numpy(x), tc,
                                         tr, index)
        _close(got, want)
        _close(tc, jc)
        _close(tr, jr)
        np.testing.assert_array_equal(tc[:, :-1].numpy(), c0[:, :-1])
        assert not np.array_equal(tc[:, -1].numpy(), c0[:, -1])


# ------------------------------------------------------------- the model


def test_spec_and_param_count_equal_the_reference():
    """Full size and smoke: the same leaves (names and shapes, ``mtp``
    and both stacks included) and the same count, from the spec alone."""
    for ref_cfg, cfg in ((ref_config(ARCH), get_config(ARCH)), _cfgs()):
        ref = dict(jax.tree_util.tree_flatten_with_path(
            RefModel(ref_cfg).spec(),
            is_leaf=lambda v: hasattr(v, "shape"))[0])
        want = {".".join(k.key for k in path): tuple(v.shape)
                for path, v in ref.items()}
        got = {n: tuple(i.shape)
               for n, i in param_lib.leaves(Model(cfg, device="cpu").spec())}
        assert got == want
        assert Model(cfg, device="cpu").param_count() == \
            RefModel(ref_cfg).param_count()
        assert cfg.param_count() == ref_cfg.param_count()    # analytic
        assert any(n.startswith("mtp.block.attn.wk_b") for n in got)
        assert any(n.startswith("decoder.dense_layers.") for n in got)


def test_init_cache_is_the_references():
    for cfg_ref, cfg in ((ref_config(ARCH), get_config(ARCH)), _cfgs()):
        want = RefModel(cfg_ref).init_cache(2, 40, abstract=True)
        got = Model(cfg, device="cpu").init_cache(2, 40)
        assert set(got) == set(want) == {"index", "c", "r"}
        for key in ("c", "r"):
            assert tuple(got[key].shape) == want[key].shape
            assert str(got[key].dtype).split(".")[-1] == \
                str(want[key].dtype)
        assert got["index"] == 0


def test_prefill_and_decode_logits_match_reference():
    """A converted model (both stacks, MoE at the default capacity, so
    decode drops the copies the reference drops): ``prefill_logits`` and
    every ``decode_step`` within 1e-5 of the reference's."""
    ref, params, port = _pair()
    B, S = 2, 10
    toks = _tokens(B, S, seed=3)
    full = port.prefill_logits({"tokens": toks})
    assert full.shape == (B, S, port.cfg.padded_vocab)
    _close(full, ref.prefill_logits(params, {"tokens": jnp.asarray(toks)}),
           tol=LOGIT_TOL)
    step = jax.jit(ref.decode_step)
    ref_cache = ref.init_cache(B, S + 2)
    cache = port.init_cache(B, S + 2)
    for t in range(S):
        want, ref_cache = step(params, ref_cache, jnp.asarray(toks[:, t:t + 1]))
        got, cache = port.decode_step(cache, toks[:, t:t + 1])
        _close(got, want, tol=LOGIT_TOL)
    _close(cache["c"], ref_cache["c"], tol=LOGIT_TOL)
    _close(cache["r"], ref_cache["r"], tol=LOGIT_TOL)
    assert cache["index"] == S


def test_absorbed_decode_agrees_with_expanded_prefill():
    """The reference's ``test_prefill_decode_logits_agree[deepseek-v3-671b]``
    on the port's own model: float32, capacity factor 8.0 (no copy drops
    in the parallel path), B = 1, S = 12; absorbed decode over the latent
    cache against the expanded prefill, 2e-3."""
    cfg = dataclasses.replace(get_config(ARCH).smoke(), param_dtype="float32",
                              capacity_factor=8.0)
    model = Model(cfg, device="cpu").init(seed=0)
    toks = _tokens(1, 12, seed=0)
    full = model.prefill_logits({"tokens": toks})
    cache = model.init_cache(1, 16)
    for t in range(12):
        logits, cache = model.decode_step(cache, toks[:, t:t + 1])
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_prefill_with_cache_fills_the_latent_cache():
    """The sequential prefill leaves the latent cache and the last logits
    that the parallel forward and a decode step after it agree with
    (capacity 8.0 and 2e-3, as above)."""
    _, _, port = _pair(capacity_factor=8.0)
    toks = _tokens(2, 7, seed=4)
    full = port.prefill_logits({"tokens": toks})
    last, cache = port.prefill_with_cache({"tokens": toks[:, :6]}, 10)
    assert cache["index"] == 6 and cache["c"].shape[2] == 10
    _close(last, full[:, 5], tol=2e-3)
    nxt, _ = port.decode_step(cache, toks[:, 6:7])
    _close(nxt, full[:, 6], tol=2e-3)


def test_mtp_head_is_carried_and_its_block_matches_reference():
    """The ``mtp`` subtree moves across leaf for leaf; the MTP head's
    forward up to the loss (the part of ``Model._mtp_loss`` before
    ``_chunked_ce``: norm of h_t, concatenated with the embedding of token
    t+1, ``proj``, one dense MLA block), composed from port functions,
    equals the same composition of reference functions."""
    ref, params, port = _pair()
    mtp = port.params["mtp"]
    for name, leaf in param_lib.leaves(mtp):
        want = params["mtp"]
        for k in name.split("."):
            want = want[k]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want))
    toks = _tokens(2, 9, seed=5)
    cfg, ref_cfg = port.cfg, ref.cfg

    h, _ = port.hidden_states({"tokens": toks})
    emb = embed_tokens(port.params["embed"], torch.as_tensor(toks[:, 1:],
                                                             dtype=torch.long),
                       h.dtype)
    z = torch.cat([apply_norm(mtp["ln"], h[:, :-1], cfg.norm_eps), emb], -1)
    z = z @ mtp["proj"]
    z, aux = tfm.apply_attn_block(mtp["block"], cfg, z,
                                  torch.arange(z.shape[1], dtype=torch.int32),
                                  use_moe=False)

    jt = jnp.asarray(toks)
    jh, _ = ref.hidden_states(params, {"tokens": jt})
    p = params["mtp"]
    jz = jnp.concatenate([ref_apply_norm(p["ln"], jh[:, :-1],
                                         ref_cfg.norm_eps),
                          ref_embed_tokens(params["embed"], jt[:, 1:],
                                           jh.dtype)], axis=-1)
    jz = jnp.einsum("bsd,de->bse", jz, p["proj"])
    jz, _ = ref_tfm.apply_attn_block(p["block"], ref_cfg, jz,
                                     jnp.arange(jz.shape[1], dtype=jnp.int32),
                                     use_moe=False)
    assert z.shape == (2, 8, cfg.d_model) and float(aux) == 0.0
    _close(z, jz, tol=LOGIT_TOL)


# ----------------------------------------------------------- serving


def test_greedy_tokens_match_reference():
    """``generate_batch``: 3 prompts of 10 tokens, 8 new, greedy, on the
    converted float32 smoke model (decode at the default capacity: a
    step's three tokens are one group, so copies may drop, alike in both
    packages)."""
    ref, params, port = _pair()
    prompts = _tokens(3, 10, seed=6)
    want = RefEngine(ref.cfg, params, cache_len=32).generate_batch(prompts, 8)
    got = ServingEngine(port, cache_len=32).generate_batch(prompts, 8)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, want)


def test_scheduler_admits_as_reference():
    """``kv_bytes`` keeps the reference's formula (num_kv_heads x
    resolved_head_dim a layer, not the latent cache's width), so the full
    config's admissions are the reference's tick by tick (prompts of up
    to 400 tokens: one request's 1.75 MB a token by that formula fits the
    budget alone)."""
    kw = dict(hbm_budget_bytes=0.05 * 16 * 2**30, flop_budget=5e15,
              max_batch=8, time_limit_s=600.0)
    ref = RefScheduler(ref_config(ARCH), **kw)
    port = PackageScheduler(get_config(ARCH), device="cpu", **kw)
    rng = np.random.default_rng(0)
    for rid in range(20):
        r = dict(rid=rid, prompt_tokens=int(rng.integers(4, 400)),
                 max_new_tokens=int(rng.integers(4, 16)),
                 priority=float(rng.uniform(0.1, 1.0)))
        ref.submit(RefRequest(**r))
        port.submit(Request(**r))
    assert port.queue[0].kv_bytes(port.cfg) == ref.queue[0].kv_bytes(ref.cfg)
    ticks = 0
    while ref.queue or port.queue:
        want = [r.rid for r in ref.tick()]
        assert [r.rid for r in port.tick()] == want, ticks
        ticks += 1
        assert ticks < 20 and want


def test_launch_serve_deepseek_on_cpu():
    """The launcher serves the MLA cache, cut with ``--layers`` as the
    full model is on one card; a cut that leaves no main-stack layer
    raises."""
    from repro_torch.launch import serve
    done = serve.main(["--arch", "deepseek-v3-671b-smoke", "--device", "cpu",
                       "--requests", "5", "--ticks", "2", "--layers", "2"])
    assert sorted(g.rid for g in done) == list(range(5))
    with pytest.raises(ValueError, match="--layers 1"):
        serve.main(["--arch", "deepseek-v3-671b-smoke", "--device", "cpu",
                    "--layers", "1"])
