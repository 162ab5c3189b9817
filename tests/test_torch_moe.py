"""The port's mixture-of-experts layer against the JAX reference.

``repro_torch.models.moe`` and ``repro.models.moe`` on the same float32
parameters (the reference's ``init_params``, carried across as numpy) and
the same numpy-seeded inputs.  Bars: 2e-4 relative and absolute on the
outputs (the reference's own MoE bar, ``tests/test_models.py``), 1e-6 on
the aux loss; routing (experts, positions, drops) exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import moe as ref_moe_lib
from repro.models.param import init_params as ref_init_params
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.convert import _convert

TOL = 2e-4


def _cfgs(arch, **changes):
    """(reference config, port config): the smoke config in float32."""
    ref = dataclasses.replace(ref_config(arch).smoke(), param_dtype="float32",
                              **changes)
    port = dataclasses.replace(get_config(arch).smoke(), param_dtype="float32",
                               **changes)
    return ref, port


def _params(ref_cfg, seed=1):
    """The reference's MoE parameters: (jax tree, the port's torch tree)."""
    jp = ref_init_params(ref_moe_lib.moe_spec(ref_cfg),
                         jax.random.PRNGKey(seed), jnp.float32)
    return jp, _convert(jax.tree.map(np.asarray, jp))


def _x(shape, seed=2):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _both(arch, x, jp=None, tp=None, **changes):
    """apply_moe of each package on x: (port out, port aux, ref out, ref
    aux, port routing, port config)."""
    ref_cfg, cfg = _cfgs(arch, **changes)
    if jp is None:
        jp, tp = _params(ref_cfg)
    want, want_aux = ref_moe_lib.apply_moe(jp, ref_cfg, jnp.asarray(x))
    xt = torch.from_numpy(x)
    got, aux = moe.apply_moe(tp, cfg, xt)
    return got, aux, want, want_aux, moe.route(tp, cfg, xt), cfg


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_apply_moe_matches_reference(capacity_factor):
    """mixtral-smoke at the default capacity (copies drop) and at 8.0 (none
    do), groups of 12 tokens (C = 8 and 12) on six inputs: outputs, aux,
    and at 8.0 the dense oracle of each package."""
    ref_cfg, _ = _cfgs("mixtral-8x22b", capacity_factor=capacity_factor)
    jp, tp = _params(ref_cfg)
    dropped = 0
    for seed in range(6):
        x = _x((3, 4, ref_cfg.d_model), seed=seed)
        got, aux, want, want_aux, r, cfg = _both(
            "mixtral-8x22b", x, jp, tp, capacity_factor=capacity_factor)
        assert got.shape == x.shape and got.dtype == torch.float32
        _close(got, want)
        assert abs(float(aux) - float(want_aux)) <= 1e-6
        dropped += int((~r.keep).sum())
        if capacity_factor == 8.0:
            _close(got, moe.ref_moe(tp, cfg, torch.from_numpy(x)))
            _close(got, ref_moe_lib.ref_moe(jp, ref_cfg, jnp.asarray(x)))
    assert (dropped == 0) == (capacity_factor == 8.0), dropped


def test_ref_moe_matches_reference():
    ref_cfg, cfg = _cfgs("mixtral-8x22b")
    jp, tp = _params(ref_cfg, seed=3)
    x = _x((3, 7, cfg.d_model), seed=4)
    _close(moe.ref_moe(tp, cfg, torch.from_numpy(x)),
           ref_moe_lib.ref_moe(jp, ref_cfg, jnp.asarray(x)))


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_shared_expert_path(capacity_factor):
    """deepseek-smoke's MoE shape (one shared expert beside the routed
    ones) against the reference; at 8.0 also against the dense oracle."""
    ref_cfg, cfg = _cfgs("deepseek-v3-671b", capacity_factor=capacity_factor)
    assert "shared" in moe.moe_spec(cfg)
    jp, tp = _params(ref_cfg)
    x = _x((1, 8, cfg.d_model))
    got, aux, want, want_aux, _, _ = _both(
        "deepseek-v3-671b", x, jp, tp, capacity_factor=capacity_factor)
    _close(got, want)
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    if capacity_factor == 8.0:
        _close(got, moe.ref_moe(tp, cfg, torch.from_numpy(x)))


@pytest.mark.parametrize("B,S", [(2, 2050), (1, 1500), (1, 1)])
def test_groups_and_capacity_as_the_reference(B, S):
    """T = 4,100 tokens: groups of 4,096 shrink to 2,050 (two groups);
    1,500 tokens in one group; one token (decode, C = 1)."""
    ref_cfg, cfg = _cfgs("mixtral-8x22b")
    x = _x((B, S, cfg.d_model), seed=5)
    got, aux, want, want_aux, r, _ = _both("mixtral-8x22b", x)
    assert r.g == {4100: 2050, 1500: 1500, 1: 1}[B * S]
    _close(got, want)
    assert abs(float(aux) - float(want_aux)) <= 1e-6


def _tied(arch, jp, tp, cols=(0, 1, 2)):
    """Router columns ``cols`` made equal (to the first of them) in both
    trees, so those experts' probabilities tie exactly for every token."""
    r = np.array(jp["router"])
    for c in cols[1:]:
        r[:, c] = r[:, cols[0]]
    jp = dict(jp, router=jnp.asarray(r))
    tp = dict(tp, router=torch.from_numpy(r.copy()))
    return jp, tp


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v3-671b"])
def test_top_k_ties_follow_the_reference(arch, monkeypatch):
    """Experts 0-2 tie for every token and the capacity binds: the port
    routes as ``jax.lax.top_k`` does (lower expert first among equals) and
    gives the reference's output; a top-k that orders ties the other way
    gives another."""
    ref_cfg, cfg = _cfgs(arch)
    jp, tp = _tied(arch, *_params(ref_cfg, seed=6))
    x = _x((2, 12, cfg.d_model), seed=7)
    _, want_idx, _ = ref_moe_lib._route(
        jp, ref_cfg, jnp.asarray(x).reshape(1, -1, cfg.d_model))
    got, aux, want, want_aux, r, _ = _both(arch, x, jp, tp)
    # the tie is exact in both: expert 2 never beats 0 or 1, and where the
    # tied three lead, the choice is (0, 1)
    assert np.array_equal(r.idx.numpy(), np.asarray(want_idx))
    assert not bool((r.idx == 2).any())
    assert bool((r.idx[..., 0] == 0).any())
    assert int((~r.keep).sum()) > 0
    _close(got, want)
    assert abs(float(aux) - float(want_aux)) <= 1e-6

    stable = moe.top_k

    def last_first(probs, k):
        """Ties broken toward the higher index."""
        vals, idx = stable(probs.flip(-1), k)
        return vals, probs.shape[-1] - 1 - idx

    monkeypatch.setattr(moe, "top_k", last_first)
    other, *_ = _both(arch, x, jp, tp)
    assert not np.allclose(other.numpy(), np.asarray(want), rtol=TOL,
                           atol=TOL)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v3-671b"])
def test_dropped_copies_add_nothing(arch):
    """Every token routes to experts 0 and 1 (their router columns tie and
    dominate): expert slots fill in token order, so every token past the
    capacity loses both copies and gets zero (mixtral) or the shared
    expert's output alone (deepseek), as in the reference."""
    ref_cfg, cfg = _cfgs(arch)
    jp, tp = _params(ref_cfg, seed=8)
    r = np.array(jp["router"])
    r[:, 1] = r[:, 0]
    r[:, 2:] = -r[:, :1]                 # logits of 2, 3 = -(those of 0, 1)
    x = _x((1, 20, cfg.d_model), seed=9)
    x[..., :] *= np.sign(x @ r[:, :1])   # every token's logit 0 positive
    jp = dict(jp, router=jnp.asarray(r))
    tp = dict(tp, router=torch.from_numpy(r.copy()))
    got, _, want, _, route, _ = _both(arch, x, jp, tp)
    _close(got, want)
    C = route.C
    assert C < 20
    assert bool((route.idx[0, :, 0] == 0).all() & (route.idx[0, :, 1] == 1)
                .all())
    assert bool(route.keep[0, :C].all() and not route.keep[0, C:].any())
    tail = got[0, C:]
    if "shared" in tp:
        from repro_torch.models.layers import apply_mlp
        shared = apply_mlp(tp["shared"], torch.from_numpy(x), "silu")
        assert torch.equal(tail, shared[0, C:])
    else:
        assert torch.count_nonzero(tail) == 0


def test_bfloat16_layer_reruns_bit_identical():
    """The activation-dtype path (bf16 products, gate cast, combine):
    finite, near the float32 oracle, and the same bits on a rerun."""
    _, cfg = _cfgs("mixtral-8x22b")
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    g = torch.Generator().manual_seed(0)
    from repro_torch.models.param import init_params
    tp = init_params(moe.moe_spec(cfg), g, torch.bfloat16, "cpu")
    x = torch.from_numpy(_x((2, 24, cfg.d_model), seed=10)).bfloat16()
    a, aux_a = moe.apply_moe(tp, cfg, x)
    b, aux_b = moe.apply_moe(tp, cfg, x)
    assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all()
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    assert aux_a.dtype == torch.float32


def test_top_k_orders_ties_by_index():
    p = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = moe.top_k(p, 3)
    assert idx.tolist() == [[1, 2, 3], [0, 1, 2]]
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(p.numpy()), 3)
    assert idx.tolist() == np.asarray(want_idx).tolist()
    assert torch.equal(vals, torch.from_numpy(np.array(want_vals)))
