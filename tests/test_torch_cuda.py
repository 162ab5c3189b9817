"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA card (decided inside the
fixture, never at import).  On the card run them with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports the JAX reference, which
this file does not need.)

Small shapes; ``chip_smoke.py`` repeats these checks at the main path's
shapes.  Tolerances: exact for counts, cuts, q and flip masks; 1e-12
relative for float64 sums and products summed in another order; flash
attention is held to the card check's bar, ``chip_smoke.flash_agreement``
(bfloat16: one bf16 ulp plus 1e-3 rms(plain) per element and a 5e-3
relative norm; float32: 2e-3 + 2e-3 |plain| and a 1e-4 relative norm).
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import attention, bfrt, dlv_scan, pricing, segstats

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _t(a, dev, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pricing_kernel(dev, dtype):
    rng = np.random.default_rng(0)
    m, N = 4, 5003
    t = functools.partial(_t, dev=dev, dtype=dtype)
    args = (t(rng.normal(size=(m, N))), t(rng.normal(size=m)),
            t(rng.normal(size=N)), _t(rng.integers(0, 3, N), dev,
                                      torch.int32),
            t(np.zeros(N)), t(rng.uniform(1, 3, N)), -1.0)
    before = pricing.launches
    got = pricing.pricing(*args)
    torch.cuda.synchronize()
    assert pricing.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for g, w in zip(got, pricing.pricing_plain(*args)):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)


def test_bfrt_select_kernel(dev):
    rng = np.random.default_rng(1)
    N = 20_000
    r = np.where(rng.random(N) < 0.3, rng.uniform(0, 10, N), np.inf)
    c = np.where(np.isfinite(r), rng.uniform(0.1, 2, N), 0.0)
    for budget in (0.5, 100.0, 1e9):
        q, flips, ok = bfrt.bfrt_select(_t(r, dev), _t(c, dev), budget)
        wq, wf, wok = bfrt.bfrt_sequential(r, c, budget)
        assert bool(ok) == wok
        if wok:
            assert int(q) == wq
            np.testing.assert_array_equal(flips.cpu().numpy(), wf)


def test_segment_stats_kernel(dev):
    rng = np.random.default_rng(2)
    n, k, G = 50_000, 4, 300
    ids = _t(np.sort(rng.integers(0, G, n)), dev, torch.int64)
    vals = _t(rng.normal(size=(n, k)), dev)
    got = segstats.segment_stats(vals, ids, G)
    want = segstats.segment_stats_plain(vals, ids, G)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


def test_dlv_scan_kernel(dev):
    rng = np.random.default_rng(3)
    lens = np.array([20_000] + list(rng.integers(50, 400, 200)))
    parts = []
    for L in lens:
        v = np.sort(rng.normal(rng.uniform(-1e3, 1e3), 1.0, L))
        parts.append(v - v.mean())
    beta = np.array([13.5 * p.var() / 50 ** 2 for p in parts])
    vals = _t(np.concatenate(parts), dev)
    kernels.reset_launches()
    got = dlv_scan.dlv_scan(vals, lens, beta)
    assert kernels.launch_counts()["dlv_scan"] == 1
    assert torch.equal(got, dlv_scan.dlv_scan_plain(vals, lens, beta))


def _flash_agreement():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.flash_agreement


@pytest.mark.parametrize("S", [1, 64, 65, 127, 128, 129, 200])
@pytest.mark.parametrize("H,KV", [(6, 2), (12, 2)])
@pytest.mark.parametrize("d", [64, 120, 128])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 70),
                                           (False, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(dev, S, H, KV, d, causal, window, dtype):
    """Kernel vs plain scan at S on both sides of the tile edges (64-key
    tiles, 64- and 128-row query tiles) and at a ragged S, with the GQA
    groups of 3 and of qwen2's 6, held to the card check's bar."""
    rng = np.random.default_rng(d + window + S)
    B = 2
    q, k, v = (_t(rng.normal(size=(B, S, h, d)), dev, torch.float32)
               .to(dtype) for h in (H, KV, KV))
    before = attention.launches
    got = attention.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    want = attention.flash_attention_plain(q, k, v, causal=causal,
                                           window=window)
    assert bool(torch.isfinite(got).all())
    err, over, rel, ok = _flash_agreement()(got, want)
    assert ok, (f"max abs err {err}, {over} of the elementwise limit, "
                f"relative norm {rel}")


def test_chunked_attention_outside_the_kernel_raises(dev):
    from repro_torch.models.attention import chunked_attention
    q = torch.zeros(1, 64, 4, 64, device=dev)
    k = v = torch.zeros(1, 64, 2, 64, device=dev)
    pos = torch.arange(64, device=dev)
    for kw in (dict(prefix_len=8), dict(scale=0.5)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            chunked_attention(q, k, v, pos, pos, causal=True, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        chunked_attention(q, k, v, pos, pos.clone(), causal=False)
    with pytest.raises(ValueError):
        attention.flash_attention(q[..., :32].contiguous(),
                                  k[..., :32].contiguous(),
                                  v[..., :32].contiguous())


def test_model_prefill_goes_through_the_kernel(dev):
    """A two-layer model with head_dim 64: prefill on the card launches the
    kernel once per layer and agrees with 12 decode steps (2e-3)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config("qwen2-1.5b").smoke(),
                              head_dim=64, param_dtype="float32")
    model = Model(cfg, device=dev).init(seed=0)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 12)), device=dev)
    before = attention.launches
    full = model.prefill_logits({"tokens": toks})
    assert attention.launches == before + cfg.num_layers
    cache = model.init_cache(2, 16)
    for t in range(12):
        logits, cache = model.decode_step(cache, toks[:, t:t + 1])
        torch.testing.assert_close(logits, full[:, t], rtol=2e-3, atol=2e-3)
