"""The port's Mamba2 SSD layer and the two stacks built on it (the
attention-free ``mamba2-1.3b`` and Jamba's hybrid periods) against the JAX
reference.

Inputs come from ``np.random.default_rng`` seeds; parameters are the
reference's (``init_params`` / ``Model.init`` under ``PRNGKey``) carried
across as numpy.  The reference's SSD layer has no Pallas kernel, so it
runs as it is on the CPU; Jamba's attention sublayer goes through the
plain version of the flash kernel here.  Every scan runs over at least two
chunks (S = 64 and 96 at the smoke chunk of 32), so the inter-chunk
recurrence is exercised.

Bars: 1e-5 in float32, layer and logits (observed ~1e-6: the three-operand
einsums contract in another order than XLA's); 2e-3 for the chunked scan
against the token-by-token oracle ``ssd_reference``, the reference's own
bar.  In bfloat16 both packages round the same products, but XLA and torch
may round a bf16 product's float32 sum at other points, so outputs are
held to 2 bf16 ulps of the output's scale: 2^-6 relative plus 2^-6 of max
|reference| absolute.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import Model as RefModel
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tfm
from repro.models.param import init_params as ref_init_params
from repro.serving import PackageScheduler as RefScheduler
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.models import Model, param as param_lib, ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import _convert, from_jax_params
from repro_torch.serving import PackageScheduler, Request, ServingEngine

MAMBA = "mamba2-1.3b"
JAMBA = "jamba-1.5-large-398b"
TOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# jamba-smoke is the reference's period-2 reduction (attention on a MoE
# FFN); "jamba-p4" the card's cut shape, one period of 4 sublayers
# (attention on a dense FFN at sublayer 2)
VARIANTS = {"mamba2": (MAMBA, {}), "jamba": (JAMBA, {}),
            "jamba-p4": (JAMBA, dict(num_layers=4, attn_period=4))}


def _cfgs(arch=MAMBA, dtype="float32", **changes):
    """(reference config, port config): the smoke config in ``dtype``."""
    ref = dataclasses.replace(ref_config(arch).smoke(), param_dtype=dtype,
                              **changes)
    port = dataclasses.replace(get_config(arch).smoke(), param_dtype=dtype,
                               **changes)
    return ref, port


def _f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype="float32", tol=TOL):
    got, want = _f32(got), _f32(want)
    if dtype == "bfloat16":
        tol = 2.0 ** -6
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _layer(dtype, seed=1, **changes):
    """mamba2-smoke's SSD parameters from the reference: (reference
    config, port config, jax tree, torch tree)."""
    ref_cfg, cfg = _cfgs(dtype=dtype, **changes)
    jp = ref_init_params(ref_ssm.ssm_spec(ref_cfg), jax.random.PRNGKey(seed),
                         DTYPES[dtype][0])
    return ref_cfg, cfg, jp, _convert(jax.tree.map(np.asarray, jp))


def _x(B, S, d, dtype, seed=0):
    """(jax, torch) inputs of shape (B, S, d) in ``dtype``."""
    x = np.random.default_rng(seed).normal(size=(B, S, d)).astype(np.float32)
    return (jnp.asarray(x, DTYPES[dtype][0]),
            torch.as_tensor(x).to(DTYPES[dtype][1]))


def _pair(variant, **changes):
    """The reference model, its parameters and the port's model holding
    them, float32 smoke."""
    arch, base = VARIANTS[variant]
    ref_cfg, cfg = _cfgs(arch, **base, **changes)
    ref = RefModel(ref_cfg)
    params = ref.init(jax.random.PRNGKey(0))
    return ref, params, from_jax_params(jax.tree.map(np.asarray, params),
                                        cfg, "cpu")


def _tokens(B, S, seed, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab,
                                                (B, S)).astype(np.int32)


# ------------------------------------------------------------- the layer


@pytest.mark.parametrize("S", [64, 96])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_projections_conv_and_gated_norm_match_reference(dtype, S):
    """``_proj_conv``, ``_causal_conv`` (float32 sums of the shifted
    slices, SiLU, the cast back) and ``_gated_norm`` (float32 out)."""
    ref_cfg, cfg, jp, tp = _layer(dtype)
    jx, tx = _x(2, S, cfg.d_model, dtype)
    jz, jxbc, jdt = ref_ssm._proj_conv(jp, ref_cfg, jx)
    z, xbc, dt = ssm._proj_conv(tp, cfg, tx)
    assert xbc.dtype == DTYPES[dtype][1] and dt.dtype == torch.float32
    for got, want in ((z, jz), (xbc, jxbc), (dt, jdt)):
        _close(got, want, dtype)
    conv = ssm._causal_conv(xbc, tp["conv"])
    assert conv.dtype == xbc.dtype
    _close(conv, ref_ssm._causal_conv(jxbc, jp["conv"]), dtype)
    y = np.random.default_rng(1).normal(
        size=(2, S, cfg.d_inner)).astype(np.float32)
    got = ssm._gated_norm(torch.as_tensor(y), z, tp["norm"], cfg.norm_eps)
    assert got.dtype == torch.float32
    _close(got, ref_ssm._gated_norm(jnp.asarray(y), jz, jp["norm"],
                                    ref_cfg.norm_eps), dtype)


@pytest.mark.parametrize("S", [64, 96])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_forward_matches_reference(dtype, S):
    """The chunked scan over 2 and 3 chunks, B = 2."""
    ref_cfg, cfg, jp, tp = _layer(dtype)
    jx, tx = _x(2, S, cfg.d_model, dtype, seed=2)
    got = ssm.ssd_forward(tp, cfg, tx)
    assert got.shape == (2, S, cfg.d_model) and got.dtype == tx.dtype
    assert bool(torch.isfinite(got.float()).all())
    _close(got, ref_ssm.ssd_forward(jp, ref_cfg, jx), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssm_decode_steps_match_reference(dtype):
    """``ssm_decode`` step by step over 40 tokens: outputs and both caches
    (the float32 state, the conv window in the parameter dtype) against
    the reference's; the port writes the caches in place."""
    ref_cfg, cfg, jp, tp = _layer(dtype)
    B, S = 2, 40
    jx, tx = _x(B, S, cfg.d_model, dtype, seed=3)
    jc = ref_ssm.ssm_init_cache(ref_cfg, B, DTYPES[dtype][0])
    tc = ssm.ssm_init_cache(cfg, B, DTYPES[dtype][1], "cpu")
    state, conv = tc["state"], tc["conv"]
    assert state.dtype == torch.float32 and conv.dtype == DTYPES[dtype][1]
    step = jax.jit(lambda p, x, c: ref_ssm.ssm_decode(p, ref_cfg, x, c))
    for t in range(S):
        want, jc = step(jp, jx[:, t:t + 1], jc)
        got, tc = ssm.ssm_decode(tp, cfg, tx[:, t:t + 1], tc)
        assert tc["state"] is state and tc["conv"] is conv
        _close(got, want, dtype)
        _close(state, jc["state"], dtype)
        _close(conv, jc["conv"], dtype)


def test_chunked_scan_agrees_with_the_sequential_oracle():
    """The reference's ``test_ssd_chunked_matches_sequential`` on the port
    (float32, B = 2, S = 96: three chunks), 2e-3; and the port's oracle
    against the reference's, 1e-5."""
    ref_cfg, cfg, jp, tp = _layer("float32", seed=4)
    jx, tx = _x(2, 96, cfg.d_model, "float32", seed=5)
    tx, jx = tx * 0.5, jx * 0.5
    seq = ssm.ssd_reference(tp, cfg, tx)
    np.testing.assert_allclose(ssm.ssd_forward(tp, cfg, tx).numpy(),
                               seq.numpy(), rtol=2e-3, atol=2e-3)
    _close(seq, ref_ssm.ssd_reference(jp, ref_cfg, jx))


def test_sequence_not_a_multiple_of_the_chunk_raises_in_both():
    """S = 40 at chunk 32: the reference asserts, the port raises a
    ``ValueError`` naming S and Q; neither pads."""
    ref_cfg, cfg, jp, tp = _layer("float32")
    jx, tx = _x(1, 40, cfg.d_model, "float32")
    with pytest.raises(AssertionError):
        ref_ssm.ssd_forward(jp, ref_cfg, jx)
    with pytest.raises(ValueError, match="S=40.*Q=32"):
        ssm.ssd_forward(tp, cfg, tx)


def test_a_log_rule_is_uniform_in_1_16_and_deterministic():
    """A = exp(A_log) lies in [1, 16) and spreads over it; one seed gives
    the same draw, another seed another; the cast follows the dtype."""
    info = param_lib.ParamInfo((4, 4096), ("layers", "ssm_heads"),
                               init="a_log")

    def draw(seed, dtype=torch.float32):
        return param_lib._init_one(info, torch.Generator().manual_seed(seed),
                                   dtype, "cpu")

    a = draw(0)
    A = torch.exp(a)
    assert float(A.min()) >= 1.0 and float(A.max()) < 16.0 + 1e-5
    assert abs(float(A.mean()) - 8.5) < 0.2
    assert float(A.min()) < 1.1 and float(A.max()) > 15.9
    assert torch.equal(a, draw(0)) and not torch.equal(a, draw(1))
    assert torch.equal(draw(0, torch.bfloat16), a.bfloat16())
    p = Model(get_config(MAMBA).smoke(), device="cpu").init(seed=0).params
    A = torch.exp(p["decoder"]["layers"]["ssm"]["A_log"].float())
    assert float(A.min()) >= 1.0 and float(A.max()) < 16.5


# ------------------------------------------------------------- the stacks


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_spec_and_param_count_equal_the_reference(variant):
    """Full size (the period cut for "jamba-p4") and smoke: the same
    leaves, names and shapes, and the same count, from the spec alone;
    the analytic counts equal too (for the full Jamba they are not the
    spec's, in the reference as in its copy)."""
    arch, changes = VARIANTS[variant]
    pairs = ((dataclasses.replace(ref_config(arch), **changes),
              dataclasses.replace(get_config(arch), **changes)),
             _cfgs(arch, **changes))
    for ref_cfg, cfg in pairs:
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
        assert cfg.param_count() == ref_cfg.param_count()     # analytic


def test_jamba_period_cut_holds_the_three_sublayer_kinds():
    """The card's cut, ``num_layers=4, attn_period=4``: SSM + dense, SSM +
    MoE, attention + dense, SSM + MoE; 22.98e9 parameters (45.96 GB in
    bf16), where one period of 8 holds 45.14e9."""
    cfg = dataclasses.replace(get_config(JAMBA), num_layers=4, attn_period=4)
    spec = Model(cfg, device="cpu").spec()["decoder"]["layers"]
    kinds = [("attn" if "attn" in spec[f"sub{i}"] else "ssm",
              "moe" if "router" in spec[f"sub{i}"]["ffn"] else "dense")
             for i in range(4)]
    assert kinds == [("ssm", "dense"), ("ssm", "moe"), ("attn", "dense"),
                     ("ssm", "moe")]
    n = Model(cfg, device="cpu").param_count()
    assert round(n / 1e9, 2) == 22.98
    period8 = dataclasses.replace(get_config(JAMBA), num_layers=8)
    assert round(Model(period8, device="cpu").param_count() / 1e9, 2) == 45.14


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_init_cache_is_the_references(variant):
    arch, changes = VARIANTS[variant]
    pairs = ((dataclasses.replace(ref_config(arch), **changes),
              dataclasses.replace(get_config(arch), **changes)),
             _cfgs(arch, **changes))
    for cfg_ref, cfg in pairs:
        want = RefModel(cfg_ref).init_cache(2, 40, abstract=True)
        got = Model(cfg, device="cpu").init_cache(2, 40)
        assert set(got) == set(want)
        for key in set(want) - {"index"}:
            assert tuple(got[key].shape) == want[key].shape, key
            assert str(got[key].dtype).split(".")[-1] == \
                str(want[key].dtype), key
        assert got["index"] == 0


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_decode_logits_match_reference(variant):
    """A converted model (Jamba at capacity 8.0, as the reference's
    ``test_prefill_decode_logits_agree``): ``prefill_logits`` at S = 64
    (two chunks) and every ``decode_step`` within 1e-5 of the reference's,
    the caches after the last step too, and each decode step within 2e-3
    of the prefill."""
    ref, params, port = _pair(variant, capacity_factor=8.0)
    B, S = 2, 64
    toks = _tokens(B, S, seed=3)
    full = port.prefill_logits({"tokens": toks})
    assert full.shape == (B, S, port.cfg.padded_vocab)
    _close(full, ref.prefill_logits(params, {"tokens": jnp.asarray(toks)}))
    step = jax.jit(ref.decode_step)
    ref_cache = ref.init_cache(B, S + 2)
    cache = port.init_cache(B, S + 2)
    for t in range(S):
        want, ref_cache = step(params, ref_cache, jnp.asarray(toks[:, t:t + 1]))
        got, cache = port.decode_step(cache, toks[:, t:t + 1])
        _close(got, want)
        np.testing.assert_allclose(got.numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3)
    for key in set(ref_cache) - {"index"}:
        _close(cache[key], ref_cache[key])
    assert cache["index"] == S


@pytest.mark.parametrize("variant", ["jamba", "jamba-p4"])
def test_hybrid_decode_with_drops_matches_reference(variant):
    """Jamba at the default capacity, B = 4: a decode step's four tokens
    are one group, so copies drop, alike in both packages; the prefill at
    S = 64 drops its own, alike too."""
    ref, params, port = _pair(variant)
    B, S = 4, 64
    toks = _tokens(B, S, seed=4)
    _close(port.prefill_logits({"tokens": toks}),
           ref.prefill_logits(params, {"tokens": jnp.asarray(toks)}))
    step = jax.jit(ref.decode_step)
    ref_cache = ref.init_cache(B, S)
    cache = port.init_cache(B, S)
    for t in range(12):
        want, ref_cache = step(params, ref_cache, jnp.asarray(toks[:, t:t + 1]))
        got, cache = port.decode_step(cache, toks[:, t:t + 1])
        _close(got, want)


def test_jamba_block_and_aux_match_reference():
    """One period of the card's cut shape (4 sublayers, two MoE) through
    ``_apply_jamba_block``: hidden states and the aux loss summed in
    sublayer order (1e-6)."""
    ref, params, port = _pair("jamba-p4")
    x = np.random.default_rng(6).normal(
        size=(2, 64, port.cfg.d_model)).astype(np.float32)
    pos = np.arange(64, dtype=np.int32)
    lp = tfm.layer(port.params["decoder"]["layers"], 0)
    got, aux = tfm._apply_jamba_block(lp, port.cfg, torch.as_tensor(x),
                                      torch.as_tensor(pos))
    jlp = jax.tree.map(lambda a: a[0], params["decoder"]["layers"])
    want, jaux = ref_tfm._apply_jamba_block(jlp, ref.cfg, jnp.asarray(x),
                                            jnp.asarray(pos))
    _close(got, want)
    assert float(jaux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("variant", ["mamba2", "jamba-p4"])
def test_prefill_with_cache_fills_the_state(variant):
    """The sequential prefill leaves the caches and the last logits that
    the parallel forward and a decode step after it agree with (2e-3)."""
    _, _, port = _pair(variant, capacity_factor=8.0)
    toks = _tokens(2, 65, seed=7)
    full = port.prefill_logits({"tokens": toks[:, :64]})
    last, cache = port.prefill_with_cache({"tokens": toks[:, :64]}, 70)
    assert cache["index"] == 64
    np.testing.assert_allclose(last.numpy(), full[:, 63].numpy(), rtol=2e-3,
                               atol=2e-3)
    nxt, _ = port.decode_step(cache, toks[:, 64:65])
    again, _ = port.prefill_with_cache({"tokens": toks}, 70)
    _close(nxt, again)


# ----------------------------------------------------------- serving


@pytest.mark.parametrize("variant", ["mamba2", "jamba"])
def test_greedy_tokens_match_reference(variant):
    """``generate_batch``: 3 prompts of 10 tokens, 8 new, greedy, on the
    converted float32 smoke model (Jamba decodes at the default capacity,
    so copies may drop, alike in both packages)."""
    ref, params, port = _pair(variant)
    prompts = _tokens(3, 10, seed=6)
    want = RefEngine(ref.cfg, params, cache_len=32).generate_batch(prompts, 8)
    got = ServingEngine(port, cache_len=32).generate_batch(prompts, 8)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_scheduler_admits_as_reference(arch):
    """``kv_bytes`` keeps the reference's formula: 0 for mamba2 (no KV
    heads), so the HBM row of the admission LP is all zeros; for Jamba it
    prices every sublayer as attention and ignores the SSM state.  The
    full config's admissions equal the reference's tick by tick."""
    kw = dict(hbm_budget_bytes=0.05 * 16 * 2**30, flop_budget=5e15,
              max_batch=8, time_limit_s=600.0)
    ref = RefScheduler(ref_config(arch), **kw)
    port = PackageScheduler(get_config(arch), device="cpu", **kw)
    rng = np.random.default_rng(0)
    for rid in range(20):
        r = dict(rid=rid, prompt_tokens=int(rng.integers(4, 400)),
                 max_new_tokens=int(rng.integers(4, 16)),
                 priority=float(rng.uniform(0.1, 1.0)))
        ref.submit(RefRequest(**r))
        port.submit(Request(**r))
    got_kv = port.queue[0].kv_bytes(port.cfg)
    assert got_kv == ref.queue[0].kv_bytes(ref.cfg)
    assert (got_kv == 0) == (arch == MAMBA)
    ticks = 0
    while ref.queue or port.queue:
        want = [r.rid for r in ref.tick()]
        assert [r.rid for r in port.tick()] == want, ticks
        ticks += 1
        assert ticks < 20 and want


def test_launch_serve_hybrid_layers():
    """``--layers`` on a hybrid arch: 4 on the full Jamba config is one
    period of 4 (checked on the spec, nothing allocated); 2 (attention on
    a MoE FFN) and 6 (attention on a MoE FFN, and no divisor of the stack)
    raise before anything is drawn; on jamba-smoke, 4 is two whole periods
    of 2 and serves end to end on the CPU."""
    from repro_torch.launch import serve
    cut = serve.cut_layers(get_config(JAMBA), 4)
    assert (cut.num_layers, cut.attn_period, cut.moe_period) == (4, 4, 2)
    assert set(Model(cut, device="cpu").spec()["decoder"]["layers"]) == \
        {"sub0", "sub1", "sub2", "sub3"}
    assert serve.cut_layers(get_config(JAMBA), 16).attn_period == 8
    for n in (2, 6):
        with pytest.raises(ValueError, match=f"--layers {n}"):
            serve.main(["--arch", JAMBA, "--device", "cpu", "--layers",
                        str(n)])
    smoke = serve.cut_layers(get_config(JAMBA).smoke(), 4)
    assert (smoke.num_layers, smoke.attn_period) == (4, 2)
    done = serve.main(["--arch", JAMBA + "-smoke", "--device", "cpu",
                       "--requests", "5", "--ticks", "2", "--layers", "4"])
    assert sorted(g.rid for g in done) == list(range(5))
    done = serve.main(["--arch", MAMBA + "-smoke", "--device", "cpu",
                       "--requests", "4", "--ticks", "1"])
    assert sorted(g.rid for g in done) == list(range(4))
    assert all(g.tokens for g in done)
