"""The port's optimizer, gradient compression, remat and train-step
behaviour, on the CPU.

``schedule`` and ``compress_with_ef`` against the reference's (float32;
the compression bit-equal, values at exact halves of a quantisation step
included, where both round half to even); remat "full" and "dots" giving
the gradients of "none" bit for bit; the reference's system tests
mirrored through ``make_train_step`` (two microbatches against one batch
at the reference's 5e-3 bar; int8-compressed training still learning);
inference bit-equal before and after ``init_train_state`` turns
gradients on, with no graph on its outputs; the SSD scan's in-place and
out-of-place intra-chunk blocks giving the same bits.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import compression as ref_comp
from repro.training.optimizer import OptHyper as RefHyper
from repro.training.optimizer import schedule as ref_schedule
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.param import leaves
from repro_torch.serving import ServingEngine
from repro_torch.training import compression
from repro_torch.training.optimizer import OptHyper, schedule
from repro_torch.training.step import (abstract_train_state,
                                       init_train_state, make_train_step)


def _f32(arch, **changes):
    return dataclasses.replace(get_config(arch).smoke(),
                               param_dtype="float32", **changes)


def _tokens(cfg, B, S, seed):
    tok = np.random.default_rng(seed).integers(1, cfg.vocab_size, (B, S))
    return {"tokens": tok, "labels": tok}


@pytest.mark.parametrize("step", [0, 1, 100, 5000, 10_000])
@pytest.mark.parametrize("hyper", [dict(), dict(lr=1e-3, warmup_steps=0),
                                   dict(warmup_steps=10, total_steps=200,
                                        min_lr_frac=0.0)])
def test_schedule_matches_reference(step, hyper):
    got = schedule(OptHyper(**hyper), torch.tensor(step, dtype=torch.int32))
    want = ref_schedule(RefHyper(**hyper), jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)


def _grad_tree(rng, shapes):
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}


def test_compress_with_ef_is_the_references_bit_for_bit():
    """Two steps of error feedback over random gradients, plus a leaf whose
    values sit at exact halves of the quantisation step (127 / amax
    scaled: g = (n + 0.5) * scale), which ``round`` sends to the even
    neighbour in both packages."""
    rng = np.random.default_rng(3)
    shapes = {"a": (7, 13), "b": (64,), "c": (3, 5, 2)}
    scale = np.float32(127.0) / np.float32(127.0)    # amax 127 -> step 1
    halves = np.array([127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -3.5, 126.5],
                      np.float32) * scale
    res_t = compression.ef_init({k: torch.zeros(s) for k, s in
                                 {**shapes, "h": halves.shape}.items()})
    res_j = {k: jnp.zeros(s, jnp.float32) for k, s in
             {**shapes, "h": halves.shape}.items()}
    for step in range(2):
        g = {**_grad_tree(rng, shapes), "h": halves}
        got, res_t = compression.compress_with_ef(
            {k: torch.as_tensor(v) for k, v in g.items()}, res_t)
        want, res_j = ref_comp.compress_with_ef(
            {k: jnp.asarray(v) for k, v in g.items()}, res_j)
        for k in g:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
            np.testing.assert_array_equal(res_t[k].numpy(),
                                          np.asarray(res_j[k]))
    assert compression.compression_ratio() == ref_comp.compression_ratio()


def test_quantize_rounds_half_to_even():
    g = torch.tensor([127.0, 0.5, 1.5, 2.5, -2.5, -0.5])
    q, s = compression._quantize(g)
    assert q.dtype == torch.int8
    assert q.tolist() == [127, 0, 2, 2, -2, 0]


def _grads(model, batch):
    model.requires_grad_(True)
    loss, _ = model.loss_fn(batch)
    return torch.autograd.grad(loss, [p for _, p in leaves(model.params)])


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "jamba-1.5-large-398b",
                                  "whisper-base", "deepseek-v3-671b"])
def test_remat_full_and_dots_give_the_gradients_of_none(arch):
    base = Model(_f32(arch), device="cpu").init(seed=0)
    batch = _tokens(base.cfg, 2, 32, 1)
    if base.cfg.is_encoder_decoder:
        batch["enc_inputs"] = np.random.default_rng(2).normal(
            size=(2, base.cfg.encoder_seq_len, base.cfg.d_model))
    want = _grads(base, batch)
    for mode in ("full", "dots"):
        m = Model(_f32(arch, remat=mode), device="cpu").load_params(
            base.params)
        got = _grads(m, batch)
        for g, w in zip(got, want):
            assert torch.equal(g, w), mode


def test_microbatched_grad_accumulation_matches():
    """The reference's system test, mirrored: 2 microbatches ~= a single
    batch step (same data, same update), at its bar (5e-3)."""
    cfg = _f32("smollm-135m")
    batch = _tokens(cfg, 4, 32, 0)
    h = OptHyper(lr=1e-3)
    out = []
    for mb in (1, 2):
        model = Model(cfg, device="cpu")
        state = init_train_state(model, torch.Generator().manual_seed(0))
        state, metrics = make_train_step(model, h, microbatches=mb)(state,
                                                                    batch)
        out.append((state, metrics))
    (s1, m1), (s2, m2) = out
    for (_, p1), (_, p2) in zip(leaves(s1["params"]), leaves(s2["params"])):
        np.testing.assert_allclose(p1.detach().numpy(), p2.detach().numpy(),
                                   rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    assert float(m2["tokens"]) == 64.0      # the last microbatch's


def _markov_batches(vocab, B, S, steps, seed=0):
    """Numpy-seeded batches with structure to learn: each next token
    follows a fixed random map of the last one 70% of the time."""
    proj = np.random.default_rng(seed).integers(1, vocab, size=vocab)
    for step in range(steps):
        rng = np.random.default_rng((seed, step))
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rng.integers(1, vocab, B)
        for i in range(1, S + 1):
            follow = rng.random(B) < 0.7
            toks[:, i] = np.where(follow, proj[toks[:, i - 1]],
                                  rng.integers(1, vocab, B))
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_compressed_training_still_learns():
    """The reference's system test, mirrored through ``make_train_step``:
    smollm-smoke, batch 4, seq 64, lr 3e-3, 20 int8-compressed steps."""
    cfg = get_config("smollm-135m").smoke()
    model = Model(cfg, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0),
                             compress=True)
    assert set(state["opt"]) == {"mu", "nu", "step", "ef"}
    step = make_train_step(model, OptHyper(lr=3e-3), compress=True)
    losses = []
    for batch in _markov_batches(cfg.vocab_size, 4, 64, 20):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.03, losses


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b"])
def test_inference_unchanged_by_init_train_state(arch):
    """Prefill logits and greedy tokens of a model are the same bits
    before and after ``init_train_state`` turns its gradients on, and no
    inference output carries a graph."""
    cfg = _f32(arch)
    model = Model(cfg, device="cpu").init(seed=0)
    toks = np.random.default_rng(4).integers(1, cfg.vocab_size, (2, 32))
    prompts = toks[:, :8].astype(np.int32)

    def run():
        logits = model.prefill_logits({"tokens": toks})
        gen = ServingEngine(model, cache_len=32).generate_batch(prompts, 6)
        step_logits, _ = model.decode_step(model.init_cache(2, 8),
                                           prompts[:, :1])
        assert logits.grad_fn is None and not logits.requires_grad
        assert step_logits.grad_fn is None
        return logits, gen, step_logits

    before = run()
    init_train_state(model)
    assert all(p.requires_grad for p in model.parameters())
    after = run()
    assert torch.equal(before[0], after[0])
    np.testing.assert_array_equal(before[1], after[1])
    assert torch.equal(before[2], after[2])


def test_ssd_in_place_and_out_of_place_agree_bit_for_bit():
    """The SSD intra-chunk block runs in place without autograd and out of
    place under it: the same arithmetic, the same bits; and a backward
    through it runs (an in-place exp_ would raise)."""
    from repro_torch.models import ssm
    from repro_torch.models.param import init_params
    cfg = _f32("mamba2-1.3b")
    p = init_params(ssm.ssm_spec(cfg), torch.Generator().manual_seed(0),
                    torch.float32, "cpu")
    x = torch.randn((2, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = ssm.ssd_forward(p, cfg, x)
    xg = x.clone().requires_grad_(True)
    got = ssm.ssd_forward(p, cfg, xg)
    assert torch.equal(got.detach(), want)
    (g,) = torch.autograd.grad(got.square().sum(), xg)
    assert bool(torch.isfinite(g).all())


def test_abstract_train_state_allocates_nothing():
    model = Model(get_config("mixtral-8x22b").smoke(), device="cpu")
    st = abstract_train_state(model)
    spec = dict(leaves(model.spec()))
    for name, t in leaves(st["params"]):
        assert t.device.type == "meta" and tuple(t.shape) == \
            spec[name].shape and t.dtype == torch.bfloat16
    for key in ("mu", "nu"):
        assert all(t.dtype == torch.bfloat16 and t.device.type == "meta"
                   for _, t in leaves(st["opt"][key]))   # opt_dtype bf16
    assert st["opt"]["step"].dtype == torch.int32


def test_training_package_exports_the_references_names():
    import repro.training as ref_training
    import repro_torch.training as training
    assert sorted(training.__all__) == sorted(ref_training.__all__)
    for name in training.__all__:
        assert callable(getattr(training, name))
