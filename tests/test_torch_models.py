"""The port's dense GQA model stack against the JAX reference.

Smoke configs at ``param_dtype="float32"``; the reference's parameters
(``Model.init(PRNGKey(0))``) carried across with ``from_jax_params``; the
same numpy-seeded tokens through both.  The bar is 2e-3 in the
reference's tests; the port holds 1e-5 (observed max abs error on the
CPU: about 6.6e-7 over logits of magnitude ~0.9).
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
from repro_torch.models import Model
from repro_torch.models.convert import from_jax_params

SMOKE_ARCHS = ["qwen2-1.5b", "smollm-135m", "h2o-danube-3-4b"]
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
    ref, params, port = _pair(arch)
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
    with pytest.raises(KeyError, match="ROADMAP"):
        get_config("mamba2-1.3b")
    with pytest.raises(KeyError, match="ROADMAP"):
        get_config("deepseek-v3-671b-smoke")
    with pytest.raises(ValueError, match="missing"):
        Model(get_config("smollm-135m-smoke"), device="cpu").load_params({})
