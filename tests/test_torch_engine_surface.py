"""The reference's API that the port does not have yet fails by name.

Each call written against ``repro.core`` that the port cannot serve
raises ``NotImplementedError`` naming its ROADMAP queue-1 item, instead
of a bare ``TypeError``, ``AttributeError`` or "unknown backend".  A case
goes away when its item lands.
"""
import numpy as np
import pytest

from repro_torch.core import bucketing, dlv, partitioner
from repro_torch.core.engine import PackageQueryEngine
from repro_torch.core.hierarchy import Hierarchy


def _table(n=2_000):
    rng = np.random.default_rng(0)
    return {"a": rng.normal(size=n), "b": rng.uniform(0, 5, n)}


@pytest.mark.parametrize("kwarg, value, item", [
    ("cache", True, "item 3"),
    ("mesh", object(), "item 6"),
])
def test_unported_engine_knobs_name_their_item(kwarg, value, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1, {item}"):
        PackageQueryEngine(_table(), ["a", "b"], device="cpu",
                           **{kwarg: value})


def test_engine_knobs_left_at_their_defaults_build():
    eng = PackageQueryEngine(_table(), ["a", "b"], cache=False, mesh=None,
                             layer0_backend=None, device="cpu")
    assert eng.n == 2_000


@pytest.mark.parametrize("method, item", [("session", "item 3")])
def test_unported_engine_methods_name_their_item(method, item):
    eng = PackageQueryEngine(_table(), ["a", "b"], device="cpu")
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1, {item}"):
        getattr(eng, method)(0)


@pytest.mark.parametrize("call", ["fit bucketing", "fit dlv", "hierarchy",
                                  "group_stats", "streaming_stats"])
def test_mesh_sharded_passes_name_item_6(call):
    """The reference's ``mesh=`` (its sharded stats passes) is item 6."""
    X = np.random.default_rng(1).normal(size=(500, 2))
    mesh = object()
    calls = {
        "fit bucketing": lambda: partitioner.fit(
            X, backend="bucketing", d_f=10, mesh=mesh, device="cpu"),
        "fit dlv": lambda: partitioner.fit(X, backend="dlv", d_f=10,
                                           mesh=mesh, device="cpu"),
        "hierarchy": lambda: Hierarchy(_table(), ["a", "b"], d_f=20,
                                       alpha=150, mesh=mesh, device="cpu"),
        "group_stats": lambda: partitioner.group_stats(
            X, np.arange(500), np.array([0, 250, 500]), mesh=mesh,
            chunk_rows=100),
        "streaming_stats": lambda: bucketing.streaming_stats(
            bucketing.ArraySource(X), 100, mesh=mesh)}
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue 1, item 6"):
        calls[call]()


def test_heap_build_names_item_8():
    X = np.random.default_rng(1).normal(size=(500, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 8"):
        dlv.dlv(X, d_f=10, method="heap", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 8"):
        partitioner.fit(X, backend="dlv", d_f=10, method="heap",
                        device="cpu")


@pytest.mark.parametrize("level", ["partition", "hierarchy"])
def test_device_descent_names_its_item(level):
    table = _table()
    h = Hierarchy(table, ["a", "b"], d_f=20, alpha=150,
                  rng=np.random.default_rng(0), device="cpu")
    T = np.stack([table["a"][:50], table["b"][:50]], axis=1)
    want = h.get_group_batch(1, T)
    assert want.shape == (50,)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 9"):
        if level == "partition":
            h.layers[1].part.get_group_batch(T, jit=True)
        else:
            h.get_group_batch(1, T, jit=True)
