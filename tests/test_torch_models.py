"""The port's GQA model stack (dense and mixture of experts) against the
JAX reference.

Smoke configs at ``param_dtype="float32"``; the reference's parameters
(``Model.init(PRNGKey(0))``) carried across with ``from_jax_params``; the
same numpy-seeded tokens through both.  The bar is 2e-3 in the
reference's tests; the port holds 1e-5 (observed max abs error on the
CPU: about 6.6e-7 over logits of magnitude ~0.9, 5.4e-7 for mixtral).
Mixtral's prefill-vs-decode case raises the capacity factor to 8.0, as
the reference's ``test_prefill_decode_logits_agree`` does, so that the
parallel path drops no copy; the decode case at B = 4 keeps the default
capacity, where both packages drop the same copies.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import Model as RefModel
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import Model, moe
from repro_torch.models import param as param_lib
from repro_torch.models.convert import from_jax_params

SMOKE_ARCHS = ["qwen2-1.5b", "smollm-135m", "h2o-danube-3-4b",
               "mixtral-8x22b"]
# per-arch changes to the smoke config for prefill-vs-decode parity
NO_DROP = {"mixtral-8x22b": dict(capacity_factor=8.0)}
TOL = 1e-5


def _pair(arch, **changes):
    ref_cfg = dataclasses.replace(ref_config(arch).smoke(),
                                  param_dtype="float32", **changes)
    cfg = dataclasses.replace(get_config(arch).smoke(),
                              param_dtype="float32", **changes)
    ref = RefModel(ref_cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = from_jax_params(jax.tree.map(np.asarray, params), cfg, "cpu")
    return ref, params, port


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    ref, params, port = _pair(arch, **NO_DROP.get(arch, {}))
    B, S = 2, 12
    toks = np.random.default_rng(0).integers(
        1, port.cfg.vocab_size, (B, S)).astype(np.int32)
    full = port.prefill_logits({"tokens": toks})
    assert full.shape == (B, S, port.cfg.padded_vocab)
    assert full.dtype == torch.float32
    _close(full, ref.prefill_logits(params, {"tokens": jnp.asarray(toks)}))
    step = jax.jit(ref.decode_step)
    ref_cache = ref.init_cache(B, S + 4)
    cache = port.init_cache(B, S + 4)
    for t in range(S):
        want, ref_cache = step(params, ref_cache, jnp.asarray(toks[:, t:t + 1]))
        got, cache = port.decode_step(cache, toks[:, t:t + 1])
        _close(got, want)
        _close(got, full[:, t])
    assert cache["index"] == S


def test_prefill_with_cache_fills_the_decode_cache():
    """The sequential prefill leaves the cache and the last logits that
    the parallel forward and a decode step after it agree with."""
    _, _, port = _pair("qwen2-1.5b")
    toks = np.random.default_rng(2).integers(
        1, port.cfg.vocab_size, (2, 9)).astype(np.int32)
    full = port.prefill_logits({"tokens": toks})
    last, cache = port.prefill_with_cache({"tokens": toks[:, :8]}, 12)
    assert cache["index"] == 8
    _close(last, full[:, 7])
    nxt, cache = port.decode_step(cache, toks[:, 8:9])
    _close(nxt, full[:, 8])


def test_sliding_window_rolling_cache():
    """Port of the reference's rolling-cache test: SWA decode over a cache
    of window slots == the full forward, and == the reference's."""
    ref, params, port = _pair("h2o-danube-3-4b", sliding_window=8)
    B, S = 1, 20
    toks = np.random.default_rng(1).integers(
        1, port.cfg.vocab_size, (B, S)).astype(np.int32)
    full = port.prefill_logits({"tokens": toks})
    _close(full, ref.prefill_logits(params, {"tokens": jnp.asarray(toks)}))
    cache = port.init_cache(B, S)
    assert cache["k"].shape[2] == 8
    for t in range(S):
        logits, cache = port.decode_step(cache, toks[:, t:t + 1])
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_init_cache_shapes(arch):
    for cache_len in (16, 5000):
        cfg = get_config(arch)
        want = RefModel(cfg).init_cache(2, cache_len, abstract=True)
        got = Model(cfg, device="cpu").init_cache(2, cache_len)
        for key in ("k", "v"):
            assert tuple(got[key].shape) == want[key].shape
            assert got[key].dtype == torch.bfloat16
        assert got["index"] == 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_equals_reference(arch):
    """Smoke: counted from real parameters.  Full: from the spec alone,
    nothing allocated (and the analytic count of the copied config)."""
    ref_cfg, cfg = ref_config(arch), get_config(arch)
    assert cfg.param_count() == ref_cfg.param_count()
    assert Model(cfg, device="cpu").param_count() == \
        RefModel(ref_cfg).param_count()
    smoke = Model(cfg.smoke(), device="cpu").init(seed=0)
    assert sum(p.numel() for p in smoke.parameters()) == \
        RefModel(ref_cfg.smoke()).param_count() == smoke.param_count()


def test_init_follows_the_reference_rules():
    """Zeros for biases, ones for norm scales, normal(0.02) for weights,
    fan-in scaling (over the stacked shape) for output projections."""
    cfg = get_config("qwen2-1.5b").smoke()
    p = Model(cfg, device="cpu").init(seed=3).params
    att = p["decoder"]["layers"]["attn"]
    assert torch.count_nonzero(att["bq"]) == 0
    assert torch.all(p["ln_f"]["scale"] == 1)
    assert abs(float(p["embed"]["embedding"].float().std()) - 0.02) < 2e-3
    wo = att["wo"].float()
    fan_in = wo.shape[0] * wo.shape[1] * wo.shape[2]
    assert abs(float(wo.std()) * fan_in ** 0.5 - 1.0) < 0.05
    again = Model(cfg, device="cpu").init(seed=3).params
    assert torch.equal(again["embed"]["embedding"], p["embed"]["embedding"])


def test_unported_archs_name_their_roadmap_item():
    """Every arch of the reference's registry resolves in the port (MLA's
    deepseek: ``tests/test_torch_mla.py``; mamba2 and jamba:
    ``tests/test_torch_ssm.py``; whisper and paligemma:
    ``tests/test_torch_encdec.py``), full and smoke; an unknown arch
    raises ``KeyError``."""
    from repro.configs import ARCH_IDS as REF_ARCH_IDS
    assert set(ARCH_IDS) == set(REF_ARCH_IDS)
    for arch in REF_ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(ref_config(arch))
        assert get_config(arch + "-smoke").name == arch + "-smoke"
    assert get_config("whisper-base").is_encoder_decoder
    assert get_config("paligemma-3b-smoke").num_prefix_tokens == 16
    assert get_config("mamba2-1.3b").family == "ssm"
    assert get_config("jamba-1.5-large-398b-smoke").attn_period == 2
    assert get_config("deepseek-v3-671b-smoke").attention == "mla"
    assert get_config("mixtral-8x22b").num_experts == 8
    assert get_config("mixtral-8x22b-smoke").num_experts == 4
    for arch in ("whisper-large", "no-such-arch-smoke"):
        with pytest.raises(KeyError, match="unknown arch"):
            get_config(arch)
    with pytest.raises(ValueError, match="missing"):
        Model(get_config("smollm-135m-smoke"), device="cpu").load_params({})


def _count_drops(monkeypatch):
    """Wrap ``moe.apply_moe`` to count the copies each call drops."""
    dropped = []
    apply = moe.apply_moe

    def counting(p, cfg, x, *a, **kw):
        dropped.append(int((~moe.route(p, cfg, x).keep).sum()))
        return apply(p, cfg, x, *a, **kw)

    monkeypatch.setattr(moe, "apply_moe", counting)
    return dropped


def test_moe_decode_with_drops_matches_reference(monkeypatch):
    """mixtral-smoke at the default capacity, B = 4: a decode step's group
    is the batch (C = ceil(4 * 2 / 4 * 1.25) = 3 slots an expert for 8
    copies), so copies drop; over 8 steps the port's logits stay the
    reference's."""
    ref, params, port = _pair("mixtral-8x22b")
    dropped = _count_drops(monkeypatch)
    B, S = 4, 8
    toks = np.random.default_rng(3).integers(
        1, port.cfg.vocab_size, (B, S)).astype(np.int32)
    step = jax.jit(ref.decode_step)
    ref_cache = ref.init_cache(B, S)
    cache = port.init_cache(B, S)
    for t in range(S):
        want, ref_cache = step(params, ref_cache, jnp.asarray(toks[:, t:t + 1]))
        got, cache = port.decode_step(cache, toks[:, t:t + 1])
        _close(got, want)
    assert len(dropped) == S * port.cfg.num_layers and sum(dropped) > 0


def test_first_k_dense_stack_prefills_as_reference_and_decode_raises():
    """A GQA MoE config with one leading dense layer (deepseek's
    ``first_k_dense``, at mixtral-smoke's shape): the spec has
    ``dense_layers``, prefill and aux equal the reference's, and decode
    raises ``NotImplementedError`` as the reference's GQA body does."""
    changes = dict(first_k_dense=1, d_ff=256)
    ref, params, port = _pair("mixtral-8x22b", **changes)
    assert set(port.params["decoder"]) == {"dense_layers", "layers"}
    assert port.params["decoder"]["dense_layers"]["ffn"]["wi"].shape == \
        (1, 128, 256)
    toks = np.random.default_rng(4).integers(
        1, port.cfg.vocab_size, (2, 10)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks)}
    _close(port.prefill_logits({"tokens": toks}),
           ref.prefill_logits(params, batch))
    _, aux = port.hidden_states({"tokens": toks})
    _, want_aux = ref.hidden_states(params, batch)
    assert abs(float(aux) - float(want_aux)) <= 1e-6 and float(aux) > 0
    with pytest.raises(NotImplementedError):
        ref.decode_step(params, ref.init_cache(2, 12), batch["tokens"][:, :1])
    with pytest.raises(NotImplementedError, match="first_k_dense"):
        port.decode_step(port.init_cache(2, 12), toks[:, :1])


def _drawn_as(model, params, seed, sliced=()):
    """Each drawn leaf of ``params`` equals a float32 ``randn`` from one
    generator seeded ``seed``, in the spec's sorted order, times the
    reference's scale (0.02, or fan-in over the stacked shape), cast: one
    draw a leaf, or one a layer for the leaves named in ``sliced``."""
    g = torch.Generator().manual_seed(seed)
    for name, info in param_lib.leaves(model.spec()):
        if info.init in ("zeros", "ones"):
            continue
        got = params
        for k in name.split("."):
            got = got[k]
        scale = info.scale if info.init == "normal" else \
            1.0 / np.sqrt(np.prod(info.shape[:-1]))
        if name in sliced:
            want = torch.stack([torch.randn(info.shape[1:], generator=g)
                                for _ in range(info.shape[0])]).mul_(scale)
        else:
            want = torch.randn(info.shape, generator=g).mul_(scale)
        assert torch.equal(got, want.to(got.dtype)), name


def test_large_leaves_are_drawn_by_layer(monkeypatch):
    """A leaf above ``DRAW_WHOLE_MAX`` is drawn one layer at a time into
    the cast tensor, by the reference's rules (normal(0.02); fan-in
    scaling over the stacked shape); leaves at or below it whole."""
    cfg = dataclasses.replace(get_config("mixtral-8x22b").smoke(),
                              num_layers=4, moe_d_ff=256)
    model = Model(cfg, device="cpu")
    big = {n for n, i in param_lib.leaves(model.spec())
           if int(np.prod(i.shape)) > 100_000}
    assert big == {"decoder.layers.ffn.wi", "decoder.layers.ffn.wg",
                   "decoder.layers.ffn.wo"}
    monkeypatch.setattr(param_lib, "DRAW_WHOLE_MAX", 100_000)
    p = model.init(seed=5).params
    _drawn_as(model, p, 5, sliced=big)
    wo = p["decoder"]["layers"]["ffn"]["wo"].float()
    fan_in = int(np.prod(wo.shape[:-1]))
    assert abs(float(wo.std()) * fan_in ** 0.5 - 1.0) < 0.05
    wi = p["decoder"]["layers"]["ffn"]["wi"].float()
    assert abs(float(wi.std()) - 0.02) < 1e-3


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "smollm-135m"])
def test_dense_draws_are_one_randn_a_leaf(arch):
    """The dense archs' draws stay one whole ``randn`` a leaf (no leaf
    reaches ``DRAW_WHOLE_MAX``, at full size either)."""
    full = Model(get_config(arch), device="cpu").spec()
    assert max(int(np.prod(i.shape)) for _, i in param_lib.leaves(full)) \
        <= param_lib.DRAW_WHOLE_MAX
    model = Model(get_config(arch).smoke(), device="cpu")
    _drawn_as(model, model.init(seed=7).params, 7)
