"""Segment statistics of the port against the JAX reference, on the CPU.

``segment_stats_tiled_plain`` is the CUDA kernel's order of additions in
torch (its tiles, lane walks, scans and carry merge; the card tests hold
the kernel to it bit for bit).  Here it runs at small geometries, so that
groups cross many lanes, steps, spans, tiles and merge blocks with few
rows, and is held with the plain ``index_add_`` version to the
reference's exact float64 host twin ``segment_stats_np``: counts exact,
sums and sums of squares within 1e-12 relative (another summation
order).  One case goes through the reference's Pallas kernel in
interpret mode, at that kernel's float32 bar (its own test's 2e-3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import segstats as ref_segstats
from repro.kernels.segstats import segment_stats_np
from repro_torch import kernels
from repro_torch.kernels import segstats

# (tile, rows a lane, lanes, warps, merge warps): one row a lane and one
# step a tile; two steps a span; four steps; three warps; the kernel's own
GEOMETRIES = {
    "tile 8": dict(tile=8, rows=1, lanes=4, warps=2, merge_warps=2),
    "tile 32": dict(tile=32, rows=2, lanes=4, warps=2, merge_warps=2),
    "tile 128": dict(tile=128, rows=2, lanes=8, warps=2, merge_warps=1),
    "tile 48": dict(tile=48, rows=2, lanes=4, warps=3, merge_warps=2),
    "kernel": dict(),
}


def _case(name, rng, k=3):
    """(vals, ids, G) of a named sorting."""
    if name == "G=1":
        n, G = 301, 1
        ids = np.zeros(n, np.int64)
    elif name == "G=n":
        n = 203
        G, ids = n, np.arange(n)
    elif name == "gaps":                 # empty groups, also at both ends
        n, G = 400, 500
        ids = np.sort(rng.choice(np.arange(5, G - 9, 4), n))
    elif name == "tile edges":           # every group ends on an edge of
        n, G = 512, 16                   # the 32-row tiles and of the 8s
        ids = np.repeat(np.arange(G), 32)
    elif name == "ragged n":             # n a multiple of no tile here
        n, G = 389, 23
        ids = np.sort(rng.integers(0, G, n))
    elif name == "n < tile":
        n, G = 5, 3
        ids = np.array([0, 0, 2, 2, 2])
    elif name == "one group 95%":
        n, G = 1000, 12
        ids = np.sort(np.where(rng.random(n) < 0.95, 4,
                               rng.integers(0, G, n)))
    else:
        raise ValueError(name)
    return rng.normal(size=(n, k)) * rng.uniform(0.1, 1e3), ids, G


CASES = ["G=1", "G=n", "gaps", "tile edges", "ragged n", "n < tile",
         "one group 95%"]


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _assert_exact_twin(got, vals, ids, G):
    want = segment_stats_np(vals, ids, G)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("geo", list(GEOMETRIES))
@pytest.mark.parametrize("case", CASES)
def test_tiled_mirror_matches_exact_host_twin(case, geo):
    vals, ids, G = _case(case, np.random.default_rng(len(case)))
    got = segstats.segment_stats_tiled_plain(_t(vals), _t(ids, torch.int64),
                                             G, **GEOMETRIES[geo])
    _assert_exact_twin(got, vals, ids, G)


@pytest.mark.parametrize("k", range(1, segstats.MAX_K + 1))
def test_tiled_mirror_every_k(k):
    """Every width the kernel takes, with empty groups, at a geometry with
    many tiles a merge block."""
    rng = np.random.default_rng(k)
    n, G = 700, 90
    ids = np.sort(rng.integers(3, G - 3, n))
    vals = rng.normal(size=(n, k))
    got = segstats.segment_stats_tiled_plain(
        _t(vals), _t(ids, torch.int64), G, **GEOMETRIES["tile 32"])
    _assert_exact_twin(got, vals, ids, G)
    assert not got[0][:3].any() and not got[0][-3:].any()


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_exact_host_twin(case):
    vals, ids, G = _case(case, np.random.default_rng(len(case) + 7))
    got = segstats.segment_stats_plain(_t(vals), _t(ids, torch.int64), G)
    _assert_exact_twin(got, vals, ids, G)


def test_tiled_mirror_matches_the_pallas_kernel():
    """Through the reference's Pallas kernel in interpret mode (float32
    one-hot matmuls), at its own test's 2e-3."""
    rng = np.random.default_rng(3)
    n, k, G = 1500, 3, 40
    ids = np.sort(rng.integers(0, G, n))
    vals = rng.normal(size=(n, k)).astype(np.float32)
    c1, s1, q1 = ref_segstats.segment_stats(
        jnp.asarray(vals), jnp.asarray(ids.astype(np.int32)), G,
        interpret=True)
    got = segstats.segment_stats_tiled_plain(
        _t(vals.astype(np.float64)), _t(ids, torch.int64), G,
        **GEOMETRIES["tile 128"])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(c1), atol=1e-3)
    for g, w in zip(got[1:], (s1, q1)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-3)


def test_tiled_mirror_is_not_the_plain_order():
    """The mirror adds in the kernel's tree, not ``index_add_``'s row
    order: on values whose sum is rounding-sensitive, the two differ at
    some tile, and each agrees with the exact twin to 1e-12 relative of
    the |v| mass."""
    rng = np.random.default_rng(9)
    n = 4096
    vals = (rng.normal(size=(n, 1)) * 10.0 ** rng.integers(-8, 8, (n, 1)))
    ids = np.zeros(n, np.int64)
    plain = segstats.segment_stats_plain(_t(vals), _t(ids, torch.int64), 1)
    tiled = [segstats.segment_stats_tiled_plain(
        _t(vals), _t(ids, torch.int64), 1, **GEOMETRIES[g])
        for g in ("tile 8", "tile 32", "kernel")]
    assert any(not torch.equal(t[1], plain[1]) for t in tiled)
    mass = np.abs(vals).sum()
    for t in tiled + [plain]:
        assert abs(float(t[1][0, 0]) - vals.sum()) <= 1e-12 * mass


@pytest.mark.parametrize("k", range(1, segstats.MAX_K + 1))
def test_kernel_geometry(k):
    """The kernel's tile is whole steps of whole lane walks, and the
    mirror refuses a tile that is not."""
    step = segstats.step_rows(k)
    assert step == segstats.LANES * segstats.WARPS * \
        segstats.rows_per_thread(k)
    assert segstats.tile_rows(k) % step == 0
    assert 1 <= segstats.rows_per_thread(k) * k <= 16
    with pytest.raises(ValueError):
        segstats.segment_stats_tiled_plain(
            torch.zeros((10, k), dtype=torch.float64),
            torch.zeros(10, dtype=torch.int64), 1, tile=step + 1)


def test_cpu_wrapper_is_the_plain_version():
    """On a CPU tensor the wrapper runs the plain version, whatever tile
    it is given, and launches nothing."""
    rng = np.random.default_rng(4)
    vals, ids, G = _case("gaps", rng)
    kernels.reset_launches()
    got = segstats.segment_stats(_t(vals), _t(ids, torch.int64), G, tile=8)
    want = segstats.segment_stats_plain(_t(vals), _t(ids, torch.int64), G)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert segstats.launches == 0
