"""The reference's API that the port does not have yet fails by name.

Each call written against ``repro.core`` that the port cannot serve
raises ``NotImplementedError`` naming its ROADMAP queue-1 item, instead
of a bare ``TypeError``, ``AttributeError`` or "unknown backend".  A case
goes away when its item lands.
"""
import numpy as np
import pytest

from repro_torch.core import partitioner
from repro_torch.core.engine import PackageQueryEngine
from repro_torch.core.hierarchy import Hierarchy


def _table(n=2_000):
    rng = np.random.default_rng(0)
    return {"a": rng.normal(size=n), "b": rng.uniform(0, 5, n)}


@pytest.mark.parametrize("kwarg, value, item", [
    ("cache", True, "item 3"),
    ("layer0_backend", "bucketing", "item 4"),
    ("chunk_rows", 1_000, "item 4"),
    ("memory_rows", 1_000, "item 4"),
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


@pytest.mark.parametrize("method, item", [("session", "item 3"),
                                          ("solve_sketchrefine", "item 5")])
def test_unported_engine_methods_name_their_item(method, item):
    eng = PackageQueryEngine(_table(), ["a", "b"], device="cpu")
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1, {item}"):
        getattr(eng, method)(0)


@pytest.mark.parametrize("backend, item", [("kdtree", "item 1"),
                                           ("bucketing", "item 4")])
def test_unported_partitioner_backends_name_their_item(backend, item):
    X = np.random.default_rng(1).normal(size=(500, 2))
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1, {item}"):
        partitioner.fit(X, backend=backend, d_f=10, device="cpu")


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
