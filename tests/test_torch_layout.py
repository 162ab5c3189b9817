"""The port's multi-device layout (sharding rules, ``constrain`` on
DTensor, ``local_map`` around the kernels' plain versions) against the
JAX reference run under its own rules.

Float32 smoke configs of seven archs (qwen2, mixtral, deepseek, mamba2,
jamba, whisper, paligemma), the reference's parameters carried across
with ``from_jax_params``.  The port runs on a spawned gloo world of 4
ranks on a (2, 2) ("data", "model") mesh (``torch_dist_worker``: no rank
imports JAX), its parameters ``shard_params``-ed and ``use_rules``
active; the reference under ``make_rules`` on a (2, 2) mesh of its 4
host devices, jitted.  B = 4 and S = 512, so the MoE archs' token groups
(1,024 tokens by the reference's sizing at dp = 2) are split over the
data axis.  Bars: prefill and decode logits (two steps) and the caches
within 1e-5; the train step of smollm, mixtral, mamba2 and jamba (the
dense stack, the MoE router's and the SSD scan's gradients summed over
the ranks that hold other groups, rows or heads): the loss within 1e-5
and every gradient within 1e-4 in relative norm (the training slice's
bars).  A
world of one rank with the rules active is bit-equal to the port without
rules.  The rules' two perf flags, sequence-parallel attention and
decode activations sharded on their embedding dim, are held to the
reference under the same flags on mixtral with 3 heads (which do not
divide the model axis, as the branch needs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_worker as W
from repro.configs import get_config as ref_config
from repro.distributed.context import use_rules as ref_use_rules
from repro.distributed.sharding import make_rules as ref_make_rules
from repro.models import Model as RefModel
from repro_torch.configs import get_config

ARCHS = ["qwen2-1.5b", "mixtral-8x22b", "deepseek-v3-671b", "mamba2-1.3b",
         "jamba-1.5-large-398b", "whisper-base", "paligemma-3b"]
TRAIN_ARCH = "smollm-135m"
TRAIN_ARCHS = [TRAIN_ARCH, "mixtral-8x22b", "mamba2-1.3b",
               "jamba-1.5-large-398b"]
B, S, ENC, STEPS, CACHE = 4, 512, 64, 2, 32
# the flags' case: the heads must not divide the model axis
FLAGS_ARCH, FLAGS_CFG = "mixtral-8x22b", dict(num_heads=3, num_kv_heads=1)
FLAGS = dict(seq_parallel_attn=True, replicate_decode_activations=True)
TOL = 1e-5
GRAD_TOL = 1e-4


def _ref(arch, cfg_kw=None):
    cfg = dataclasses.replace(ref_config(arch).smoke(), param_dtype="float32",
                              **(cfg_kw or {}))
    model = RefModel(cfg)
    return model, model.init(jax.random.PRNGKey(0))


def _batch(cfg, seed=0, labels=False):
    rng = np.random.default_rng(seed)
    s = S - cfg.num_prefix_tokens
    out = {"tokens": rng.integers(1, cfg.vocab_size, (B, s)).astype(np.int32)}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab_size, (B, s)).astype(
            np.int32)
    if cfg.is_encoder_decoder:
        out["enc_inputs"] = rng.normal(size=(B, ENC, cfg.d_model)).astype(
            np.float32)
    if cfg.num_prefix_tokens:
        out["prefix"] = rng.normal(
            size=(B, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    return out


def _placed(rules, model, params):
    shard = rules.param_sharding(model.abstract_params(), model.axes())
    return jax.device_put(params, shard)


def _ref_run(model, params, batch, mesh, flags=None):
    """The reference's prefill logits, decode logits and caches under its
    rules on ``mesh`` (``flags`` replaced in them)."""
    cfg = model.cfg
    rules = dataclasses.replace(ref_make_rules(mesh), **(flags or {}))
    p = _placed(rules, model, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    with ref_use_rules(rules):
        out["prefill"] = np.asarray(jax.jit(model.prefill_logits)(p, jb))
        cache = model.init_cache(
            B, CACHE, enc_len=ENC if cfg.is_encoder_decoder else None)
        step = jax.jit(model.decode_step)
        for t in range(STEPS):
            logits, cache = step(p, cache, jb["tokens"][:, t:t + 1])
            out[f"decode{t}"] = np.asarray(logits)
    out["cache"] = {k: np.asarray(v) for k, v in cache.items()
                    if k != "index"}
    return out


def _ref_train(model, params, batch, mesh):
    rules = ref_make_rules(mesh)
    p = _placed(rules, model, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with ref_use_rules(rules):
        (loss, _), grads = jax.jit(jax.value_and_grad(
            model.loss_fn, has_aux=True))(p, jb)
    flat = jax.tree.flatten_with_path(grads)[0]
    g = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
         for path, v in flat}
    return {"loss": np.asarray(loss), "grads": g}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, the port's rank results) by case; the port's
    on one spawned world of 4 ranks, every case in it, which runs while
    the reference computes its own."""
    # Auto axes, as GSPMD lowers the reference's constraints (the
    # installed jax's make_mesh defaults to explicit axes)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    specs = [(arch, arch, None, None) for arch in ARCHS]     # name, arch,
    specs.append(("flags", FLAGS_ARCH, FLAGS_CFG, FLAGS))    # cfg, flags
    inputs, cases = {}, []
    for name, arch, cfg_kw, flags in specs:
        model, params = _ref(arch, cfg_kw)
        batch = _batch(model.cfg)
        inputs[name] = (model, params, batch, flags)
        cases.append((name, "layout", dict(
            arch=arch, params=jax.tree.map(np.asarray, params), batch=batch,
            decode_steps=STEPS, cache_len=CACHE, cfg_kw=cfg_kw,
            flags=flags)))
    train = {}
    for arch in TRAIN_ARCHS:
        model, params = _ref(arch)
        batch = _batch(model.cfg, seed=1, labels=True)
        train[arch] = (model, params, batch)
        cases.append((f"train {arch}", "layout", dict(
            arch=arch, params=jax.tree.map(np.asarray, params),
            batch=batch, train=True)))
    world = W.start(4, tuple(cases), tmp_path_factory.mktemp("layout4"))
    try:
        ref = {name: _ref_run(m, p, b, mesh, flags)
               for name, (m, p, b, flags) in inputs.items()}
        for arch, (model, params, batch) in train.items():
            ref[f"train {arch}"] = _ref_train(model, params, batch, mesh)
    finally:
        # ~20-40 s on an idle 8-core host, ~140 s beside the other test
        # workers (four single-threaded ranks, DTensor's host dispatch):
        # a wider limit than the pricing worlds' tells a hang from a load
        ranks = W.join(world, join_s=3 * W.JOIN_S)
    return ref, ranks


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _check_prefill_and_decode(ranks, name, want):
    for res in ranks:                        # every rank gathers the same
        got = res[name]
        _close(got["prefill"], want["prefill"])
        for t in range(STEPS):
            _close(got[f"decode{t}"], want[f"decode{t}"])
        assert set(got["cache"]) == set(want["cache"])
        for k in want["cache"]:
            _close(got["cache"][k], want["cache"][k])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference_on_2x2(runs, arch):
    ref, ranks = runs
    _check_prefill_and_decode(ranks, arch, ref[arch])


def test_perf_flags_match_the_reference_on_2x2(runs):
    """``seq_parallel_attn`` (S over the model axis around attention,
    whose 3 heads do not divide it) and ``replicate_decode_activations``
    (decode activations and MoE dispatch on the embedding dim over dp),
    both set in the port's rules and the reference's."""
    ref, ranks = runs
    _check_prefill_and_decode(ranks, "flags", ref["flags"])


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_matches_the_reference_on_2x2(runs, arch):
    ref, ranks = runs
    want = ref[f"train {arch}"]
    got = ranks[0][f"train {arch}"]
    _close(got["loss"], want["loss"])
    assert set(got["grads"]) == set(want["grads"])
    for name, g in want["grads"].items():
        err = np.linalg.norm(got["grads"][name] - g) / max(
            np.linalg.norm(g), 1e-30)
        assert err < GRAD_TOL, (name, err)


# ------------------------------------------------- a world of one rank


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    with W.world1(tmp_path_factory.mktemp("layout1") / "store"):
        yield W.mesh((1, 1))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x22b",
                                  "mamba2-1.3b", "paligemma-3b"])
def test_one_rank_is_bit_equal_to_no_rules(world1, arch):
    _, params = _ref(arch)
    params = jax.tree.map(np.asarray, params)
    cfg = dataclasses.replace(get_config(arch + "-smoke"),
                              param_dtype="float32")
    batch = _batch(cfg)
    batch["tokens"] = batch["tokens"][:, :64]
    got = W.layout_run(world1, cfg, params, batch, STEPS, CACHE)
    want = W.layout_run(world1, cfg, params, batch, STEPS, CACHE,
                        rules=False)
    for k in ("prefill", "decode0", "decode1"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in want["cache"]:
        np.testing.assert_array_equal(got["cache"][k], want["cache"][k])


def test_one_rank_train_step_is_bit_equal_to_no_rules(world1):
    _, params = _ref(TRAIN_ARCH)
    params = jax.tree.map(np.asarray, params)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH + "-smoke"),
                              param_dtype="float32")
    batch = _batch(cfg, seed=1, labels=True)
    batch = {k: v[:, :64] for k, v in batch.items()}
    got = W.layout_run(world1, cfg, params, batch, train=True)
    want = W.layout_run(world1, cfg, params, batch, train=True, rules=False)
    np.testing.assert_array_equal(got["loss"], want["loss"])
    for name in want["grads"]:
        np.testing.assert_array_equal(got["grads"][name], want["grads"][name])


def test_constrain_is_the_identity_without_rules():
    import torch
    from repro_torch.distributed.context import (constrain, constrain_cache,
                                                 constrain_decode_act)
    x = torch.zeros(4, 8, 2)
    assert constrain(x, ("dp", None, "tp")) is x
    assert constrain_decode_act(x) is x
    assert constrain_cache(x, "kv") is x


def test_constrain_under_rules_raises_at_its_call_site(world1):
    import torch
    from repro_torch.distributed.context import constrain, use_rules
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.mesh import make_abstract_mesh
    with use_rules(make_rules(world1)):
        with pytest.raises(TypeError, match="test_torch_layout.py"):
            constrain([1, 2], ("dp",))
        with pytest.raises(ValueError, match="spec"):
            constrain(torch.zeros(2, 3), ("dp",))
    with use_rules(make_rules(make_abstract_mesh((2, 2),
                                                 ("data", "model")))):
        with pytest.raises(TypeError, match="abstract"):
            constrain(torch.zeros(4, 4), ("dp", None))


def test_a_dtensor_reaching_a_kernel_wrapper_raises(world1):
    import torch
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.kernels.attention import chunked_scan, flash_attention
    q = DTensor.from_local(torch.zeros(1, 8, 2, 16), world1,
                           [Replicate(), Replicate()])
    pos = torch.arange(8)
    with pytest.raises(TypeError, match="local_map"):
        chunked_scan(q, q, q, pos, pos, causal=True)
    with pytest.raises(TypeError, match="local_map"):
        flash_attention(q, q, q)


def test_recomputation_keeps_the_rules_off_the_forward_thread(world1):
    """On a card autograd runs the backward, and so the checkpointed
    layers' and cross-entropy chunks' recomputation, on its own thread.
    The engine carries the calling thread's C++ state there (DTensor's
    implicit replication among it: seen on the H100), not Python's, so
    the forward's rules (thread-local, as the reference's) are not
    active: ``checkpoint_context_fn`` re-enters them.  Here the backward
    runs on another thread on purpose, with the C++ flag set as the
    engine would set it."""
    from torch.distributed.tensor import DTensor
    import threading
    import torch
    from repro_torch.distributed.context import use_rules
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.models.convert import from_jax_params
    from repro_torch.models.param import leaves
    _, params = _ref(TRAIN_ARCH)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH + "-smoke"),
                              param_dtype="float32", remat="full")
    batch = {k: torch.as_tensor(v[:, :64]) for k, v in
             _batch(cfg, seed=1, labels=True).items()}
    grads = {}
    for where in ("here", "thread"):
        model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
        make_rules(world1).shard_params(model)
        model.requires_grad_(True)
        flat = [q for _, q in leaves(model.params)]
        with use_rules(make_rules(world1)):
            loss, _ = model.loss_fn(batch)
            out = {}
            if where == "here":
                out["g"] = torch.autograd.grad(loss, flat)
            else:
                def backward():
                    DTensor._op_dispatcher._allow_implicit_replication = \
                        True
                    out.update(g=torch.autograd.grad(loss, flat))
                t = threading.Thread(target=backward)
                t.start()
                t.join()
        grads[where] = [W._full(g) for g in out["g"]]
    for a, b in zip(grads["here"], grads["thread"]):
        np.testing.assert_array_equal(a, b)
