"""The port's training loss, gradients and train step against the JAX
reference, on the CPU.

Smoke configs at ``param_dtype="float32"``, the reference's parameters
(``Model.init(PRNGKey(0))``) carried across with ``from_jax_params``, the
same numpy-seeded batch (B = 2, S = 32, labels = tokens, stub frames and
patches where the family takes them) through both.  Bars, each with what
was observed on this CPU:

- ``loss_fn``'s total and its ``ce``/``aux``/``mtp`` metrics: 1e-5
  (observed <= 1e-6); ``tokens`` exact;
- gradients leaf by leaf: relative norm ||port - ref|| / ||ref|| <= 1e-4
  (observed <= 1.5e-6, 3.1e-5 for mamba2's SSD and 1.4e-5 for jamba's);
- one AdamW step's parameters 1e-5 (observed <= 1.3e-6) and float32
  moments 1e-5 of the leaf's largest magnitude; bf16 moments (mixtral,
  jamba, deepseek store them in bf16) one bf16 ulp, 2^-8 of the leaf's
  largest magnitude, since float32 values that agree to ~1e-6 may round
  to neighbouring bf16 values.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import Model as RefModel
from repro.training.optimizer import OptHyper as RefHyper
from repro.training.step import init_train_state as ref_init_state
from repro.training.step import make_train_step as ref_make_step
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import Model
from repro_torch.models.convert import from_jax_params, from_jax_train_state
from repro_torch.models.param import leaves
from repro_torch.training.optimizer import OptHyper
from repro_torch.training.step import init_train_state, make_train_step

TOL = 1e-5
GRAD_REL = 1e-4
BF16_ULP = 2.0 ** -8


def make_batch(cfg, B=2, S=32, seed=0):
    """The reference's ``tests/test_models.py::make_batch`` as numpy."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tok, "labels": tok}
    if cfg.is_encoder_decoder:
        batch["enc_inputs"] = rng.normal(
            size=(B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.num_prefix_tokens:
        batch["prefix"] = rng.normal(
            size=(B, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _cfgs(arch, **changes):
    return (dataclasses.replace(ref_config(arch).smoke(),
                                param_dtype="float32", **changes),
            dataclasses.replace(get_config(arch).smoke(),
                                param_dtype="float32", **changes))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_smoke_forward_and_train_step(arch):
    """The reference's test of the same name, on the port: reduced config
    (its own dtype, bf16), one train step on the CPU, a positive finite
    loss, the parameters finite and the first leaf's shape kept."""
    cfg = get_config(arch).smoke()
    model = Model(cfg, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    first = next(iter(leaves(state["params"])))[1].detach().clone()
    new_state, metrics = make_train_step(model, OptHyper(lr=1e-3))(
        state, make_batch(cfg))
    assert bool(torch.isfinite(metrics["loss"])), arch
    assert float(metrics["loss"]) > 0
    p1 = next(iter(leaves(new_state["params"])))[1]
    assert p1.shape == first.shape
    assert all(bool(torch.isfinite(p.float()).all())
               for _, p in leaves(new_state["params"]))
    assert int(new_state["opt"]["step"]) == 1


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_reference(arch):
    rc, pc = _cfgs(arch)
    ref = RefModel(rc)
    params = ref.init(jax.random.PRNGKey(0))
    batch = make_batch(pc)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        ref.loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    port = from_jax_params(_np_tree(params), pc, "cpu")
    port.requires_grad_(True)
    total, got = port.loss_fn(batch)
    assert set(got) == set(metrics)
    np.testing.assert_allclose(float(total), float(loss), rtol=TOL, atol=TOL)
    for k in metrics:
        assert got[k].grad_fn is None
        np.testing.assert_allclose(float(got[k]), float(metrics[k]),
                                   rtol=TOL if k != "tokens" else 0,
                                   atol=TOL if k != "tokens" else 0)
    flat = [p for _, p in leaves(port.params)]
    gs = torch.autograd.grad(total, flat)
    want = dict(leaves(_np_tree(grads)))
    for (name, _), g in zip(leaves(port.params), gs):
        w = want[name]
        assert g.shape == w.shape, name
        rel = np.linalg.norm(g.numpy() - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= GRAD_REL, (name, rel)


def _held_state(got, want):
    """The port's state against the reference's (numpy) after a step."""
    for name, p in leaves(got["params"]):
        np.testing.assert_allclose(p.detach().numpy(),
                                   dict(leaves(want["params"]))[name],
                                   rtol=TOL, atol=TOL, err_msg=name)
    for key in ("mu", "nu"):
        ref_m = dict(leaves(want["opt"][key]))
        for name, m in leaves(got["opt"][key]):
            w = np.asarray(ref_m[name], np.float32)
            assert m.dtype == getattr(torch, str(ref_m[name].dtype)), name
            bar = (BF16_ULP if m.dtype == torch.bfloat16 else TOL) \
                * max(float(np.abs(w).max()), 1e-30)
            err = float(np.abs(m.float().numpy() - w).max())
            assert err <= bar, (key, name, err, bar)
    assert int(got["opt"]["step"]) == int(want["opt"]["step"])


@pytest.mark.parametrize("arch", ["smollm-135m", "mixtral-8x22b"])
def test_adamw_steps_match_reference(arch):
    """One step from zero moments, then a second from the reference's
    state after the first, carried across with ``from_jax_train_state``
    (non-zero moments): parameters, moments (mixtral's in bf16), step and
    metrics against the reference's jitted ``make_train_step``."""
    rc, pc = _cfgs(arch)
    ref = RefModel(rc)
    ref_step = jax.jit(ref_make_step(ref, RefHyper(lr=1e-3)))
    batches = [make_batch(pc, seed=s) for s in (0, 1)]
    ref_state = ref_init_state(ref, jax.random.PRNGKey(0))
    model, state = from_jax_train_state(_np_tree(ref_state), pc, "cpu")
    assert state["opt"]["mu"]["embed"]["embedding"].dtype == \
        getattr(torch, pc.opt_dtype)
    step = make_train_step(model, OptHyper(lr=1e-3))
    for i, b in enumerate(batches):
        ref_state, ref_m = ref_step(ref_state, {k: jnp.asarray(v)
                                                for k, v in b.items()})
        state, m = step(state, b)
        want = _np_tree(ref_state)
        _held_state(state, want)
        assert set(m) == set(ref_m)
        for k in ref_m:
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)
        # the second step starts again from the reference's own state
        model, state = from_jax_train_state(want, pc, "cpu")
        step = make_train_step(model, OptHyper(lr=1e-3))
