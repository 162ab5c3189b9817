"""The port's serving tier against the JAX reference: package-query
admission (tick by tick), greedy generation, and the serve launcher.

Admissions must be identical request for request: both schedulers solve
the same package query with Dual Reducer and B&B at ``wave_width=8``
(the default), whose wide flights the port's batched LP engine solves
(here its plain version: the schedulers run with ``device="cpu"``).  Greedy
tokens must be identical on the same converted parameters and prompts.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import Model as RefModel
from repro.serving import PackageScheduler as RefScheduler
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.core import guard
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import PackageScheduler, Request, ServingEngine


def _requests(n, seed, prompt=(4, 24), new=(4, 16)):
    rng = np.random.default_rng(seed)
    return [dict(rid=rid, prompt_tokens=int(rng.integers(*prompt)),
                 max_new_tokens=int(rng.integers(*new)),
                 priority=float(rng.uniform(0.1, 1.0))) for rid in range(n)]


@pytest.mark.parametrize("arch,hbm_frac,n", [("qwen2-1.5b", 0.05, 24),
                                             ("smollm-135m", 6e-3, 30),
                                             ("mixtral-8x22b-smoke", 1.5e-4,
                                              24)])
def test_scheduler_admits_as_reference(arch, hbm_frac, n):
    """Same submits -> the same request ids admitted on every tick, and no
    tick ends in an ERROR report.  The second and third cases make the KV
    budget bind, so the admission is a knapsack that B&B has to branch on
    (the third prices a MoE's prefill by its active parameters).  The
    wall-clock deadline is set far out: on a loaded host the reference's
    first tick (which compiles its batched LP engine) can pass the 5 s
    default and degrade, which would compare clocks, not solvers."""
    kw = dict(hbm_budget_bytes=hbm_frac * 16 * 2**30, flop_budget=5e13,
              max_batch=8, time_limit_s=600.0)
    ref = RefScheduler(ref_config(arch), **kw)
    port = PackageScheduler(get_config(arch), device="cpu", **kw)
    assert port.wave_width == ref.wave_width == 8
    for r in _requests(n, seed=0, prompt=(4, 2048)):
        ref.submit(RefRequest(**r))
        port.submit(Request(**r))
    ticks = 0
    while ref.queue or port.queue:
        want = [r.rid for r in ref.tick()]
        got = [r.rid for r in port.tick()]
        assert port.last_report.status != guard.ERROR, \
            port.last_report.notes
        assert got == want, (ticks, got, want)
        assert port.last_report.status == ref.last_report.status
        ticks += 1
        assert ticks < 20 and want
    assert port.admitted_total == ref.admitted_total == n


def _greedy_pair(arch):
    """(reference tokens, port tokens) of ``generate_batch``: 3 prompts of
    10 tokens, 8 new, float32 smoke parameters of the reference."""
    ref_cfg = dataclasses.replace(ref_config(arch).smoke(),
                                  param_dtype="float32")
    cfg = dataclasses.replace(get_config(arch).smoke(),
                              param_dtype="float32")
    params = RefModel(ref_cfg).init(jax.random.PRNGKey(0))
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg, "cpu")
    prompts = np.random.default_rng(5).integers(
        1, cfg.vocab_size, (3, 10)).astype(np.int32)
    want = RefEngine(ref_cfg, params, cache_len=32).generate_batch(prompts, 8)
    got = ServingEngine(model, cache_len=32).generate_batch(prompts, 8)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    return want, got


def test_generate_batch_greedy_matches_reference():
    np.testing.assert_array_equal(*_greedy_pair("qwen2-1.5b"))


def test_generate_batch_greedy_matches_reference_moe():
    """mixtral-smoke at the default capacity: a decode step's three tokens
    are one group (C = 2 slots an expert for 6 copies), so copies may drop,
    in the reference and the port alike."""
    np.testing.assert_array_equal(*_greedy_pair("mixtral-8x22b"))


def test_temperature_sampling_is_seeded():
    model = from_jax_params(
        jax.tree.map(np.asarray, RefModel(ref_config("smollm-135m").smoke())
                     .init(jax.random.PRNGKey(1))),
        get_config("smollm-135m").smoke(), "cpu")
    prompts = np.ones((2, 4), np.int32)
    a, b = (ServingEngine(model, cache_len=16, seed=7).generate_batch(
        prompts, 6, temperature=1.0) for _ in range(2))
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < model.cfg.vocab_size)).all()


def test_serve_records_every_tick():
    from repro_torch.models import Model
    cfg = get_config("smollm-135m").smoke()
    sched = PackageScheduler(cfg, hbm_budget_bytes=2**30, flop_budget=5e13,
                             max_batch=3, device="cpu")
    for r in _requests(5, seed=2):
        sched.submit(Request(**r))
    engine = ServingEngine(Model(cfg, device="cpu").init(seed=0),
                           cache_len=48)
    done = engine.serve(sched, ticks=3)
    assert sorted(g.rid for g in done) == list(range(5))
    log = engine.tick_log
    assert [t.admitted for t in log] == [3, 2, 0]
    assert all(t.status == guard.OK for t in log[:2])
    assert log[0].tokens == sum(len(g.tokens) for g in done[:3])


def test_launch_serve_on_cpu_and_not_without_a_device():
    from repro_torch.launch import serve
    done = serve.main(["--arch", "qwen2-1.5b-smoke", "--device", "cpu",
                       "--requests", "8", "--ticks", "4"])
    assert len(done) == 8
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card contract is moot")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "qwen2-1.5b-smoke", "--requests", "2"])


def test_launch_serve_moe_on_cpu():
    from repro_torch.launch import serve
    done = serve.main(["--arch", "mixtral-8x22b-smoke", "--device", "cpu",
                       "--requests", "6", "--ticks", "3"])
    assert sorted(g.rid for g in done) == list(range(6))
