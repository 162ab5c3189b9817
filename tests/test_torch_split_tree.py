"""The port's split-tree descent against the reference's, on the CPU.

``kernels.split_tree.descend_batch_plain`` (the plain version of
``csrc/split_tree.cu``) and ``Partition.get_group_batch(T, jit=True,
device="cpu")`` must give exactly the leaves of the reference's host
``SplitTree.descend_batch``, its jitted ``descend_batch_jax`` and (away
from NaN, which ``np.searchsorted`` orders last) the scalar ``descend``,
on the trees of every backend (dlv, kdtree, bucketing, the bound-less
merged single-bucket tree) and a single-leaf tree, for member rows, ties
on the bounds, probes outside every box and NaN rows.  The trees
themselves are the reference's, array for array.  Without a card the
device descent on ``"cuda"`` raises; it never falls back to the CPU.
"""
import numpy as np
import pytest
import torch

from repro.core import partitioner as ref_partitioner
from repro_torch.core import partitioner
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.partitioner import SplitTree
from repro_torch.kernels import split_tree

TREE_FIELDS = ("attr", "bound_off", "bounds", "children")


@pytest.fixture(scope="module")
def X():
    rng = np.random.default_rng(7)
    return np.concatenate([
        rng.normal(0, 1, (4000, 3)),
        rng.normal(7, 2, (4000, 3)),
    ]) * np.array([1.0, 4.0, 0.3])


def _fits(X):
    return {"dlv": dict(d_f=60), "kdtree": dict(d_f=60),
            "bucketing": dict(d_f=60, memory_rows=3000)}


@pytest.fixture(scope="module", params=["dlv", "kdtree", "bucketing",
                                        "merged", "single"])
def fitted(request, X):
    """(name, reference partition, port partition, data)."""
    name = request.param
    if name == "single":
        ref = ref_partitioner.fit(X[:50], backend="kdtree", tau=10**6)
        port = partitioner.fit(X[:50], backend="kdtree", tau=10**6,
                               device="cpu")
        assert ref.tree.num_nodes == port.tree.num_nodes == 0
        return name, ref, port, X[:50]
    if name == "merged":
        data = np.full((3000, 2), 5.0)
        ref = ref_partitioner.fit(data, backend="bucketing")
        port = partitioner.fit(data, backend="bucketing", device="cpu")
        # the merged tree has nodes without bounds
        assert np.any(np.diff(port.tree.bound_off) == 0)
        return name, ref, port, data
    kw = _fits(X)[name]
    ref = ref_partitioner.fit(X, backend=name, **kw)
    port = partitioner.fit(X, backend=name, device="cpu", **kw)
    return name, ref, port, X


def _probes(data, tree, seed=1):
    """Member rows, rows with ties on the bounds, rows outside every box,
    and rows with NaN in one attribute or all."""
    rng = np.random.default_rng(seed)
    n, k = data.shape
    rows = data[rng.choice(n, 2000, replace=True)]
    ties = data[rng.choice(n, 500, replace=True)].copy()
    if len(tree.bounds):
        for j in range(k):
            ties[:, j] = rng.choice(tree.bounds, len(ties))
    span = data.max(0) - data.min(0) + 1.0
    outside = np.concatenate([
        data.min(0) - span * rng.uniform(1, 10, (300, k)),
        data.max(0) + span * rng.uniform(1, 10, (300, k)),
        np.where(rng.random((300, k)) < 0.5, -1e300, 1e300)])
    nan = data[rng.choice(n, 200, replace=True)].copy()
    nan[np.arange(200), rng.integers(0, k, 200)] = np.nan
    nan[:20] = np.nan
    return np.concatenate([rows, ties, outside]), nan


def _plain(tree, T):
    arrays = [torch.as_tensor(np.asarray(getattr(tree, f)))
              for f in TREE_FIELDS]
    arrays[0] = arrays[0].to(torch.int32)
    return split_tree.descend_batch_plain(torch.as_tensor(T), *arrays,
                                          int(tree.root)).numpy()


def test_port_trees_are_the_references(fitted):
    _, ref, port, _ = fitted
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(port.tree, f),
                                      getattr(ref.tree, f))
    assert port.tree.root == ref.tree.root
    np.testing.assert_array_equal(port.gid, ref.gid)


def test_plain_descent_matches_every_reference_descent(fitted):
    name, ref, port, data = fitted
    finite, nan = _probes(data, port.tree)
    for T in (finite, nan):
        want = ref.tree.descend_batch(T)
        np.testing.assert_array_equal(
            np.asarray(ref.tree.descend_batch_jax(T)), want, err_msg=name)
        np.testing.assert_array_equal(_plain(port.tree, T), want,
                                      err_msg=name)
        np.testing.assert_array_equal(
            port.get_group_batch(T, jit=True, device="cpu"), want,
            err_msg=name)
    scalar = np.fromiter((ref.tree.descend(t) for t in finite), np.int64,
                         len(finite))
    np.testing.assert_array_equal(_plain(port.tree, finite), scalar,
                                  err_msg=name)


def test_device_descent_gives_membership(fitted):
    """Every row descends to its own group (the reference's bar)."""
    name, _, port, data = fitted
    got = port.get_group_batch(data, jit=True, device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, port.gid, err_msg=name)


def test_empty_batch_and_single_leaf():
    leaf = SplitTree.single_leaf()
    T = np.zeros((0, 3))
    assert _plain(leaf, T).shape == (0,)
    np.testing.assert_array_equal(_plain(leaf, np.ones((4, 3))),
                                  np.zeros(4, np.int64))
    other = SplitTree(np.zeros(0, np.int32), np.zeros(1, np.int64),
                      np.zeros(0), np.zeros(0, np.int64), ~5)
    np.testing.assert_array_equal(
        other.descend_batch_device(np.ones((3, 2)), "cpu").numpy(),
        np.full(3, 5))


def test_device_copies_are_made_once_per_device(X):
    part = partitioner.fit(X, backend="kdtree", d_f=60, device="cpu")
    a = part.tree.device_arrays("cpu")
    b = part.tree.device_arrays(torch.device("cpu"))
    assert a is b and a[0].dtype == torch.int32
    assert part.tree == SplitTree(part.tree.attr, part.tree.bound_off,
                                  part.tree.bounds, part.tree.children,
                                  part.tree.root)


def test_hierarchy_descent_on_its_device():
    rng = np.random.default_rng(0)
    table = {"a": rng.normal(size=3000), "b": rng.uniform(0, 5, 3000)}
    h = Hierarchy(table, ["a", "b"], d_f=10, alpha=40, device="cpu")
    assert h.L >= 2
    for l in range(1, h.L + 1):
        T = h.layers[l - 1].X
        np.testing.assert_array_equal(h.get_group_batch(l, T, jit=True),
                                      h.get_group_batch(l, T))
        np.testing.assert_array_equal(h.get_group_batch(l, T, jit=True),
                                      h.layers[l].part.gid)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card contract is moot")


def test_device_descent_raises_without_a_card(X):
    _no_cuda()
    part = partitioner.fit(X, backend="kdtree", d_f=60, device="cpu")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        part.get_group_batch(X[:10], jit=True)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        part.get_group_batch(X[:10], jit=True, device="cuda")
    h = Hierarchy({"a": X[:, 0], "b": X[:, 1]}, ["a", "b"], d_f=60,
                  alpha=400, device="cpu")
    h.device = torch.device("cuda")       # as a hierarchy built on a card
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        h.append(X[:5, :2])
    assert h._append_state is not None    # the host moments ran first


def test_kernel_wrapper_takes_cpu_tensors_to_the_plain_version(X):
    part = partitioner.fit(X, backend="dlv", d_f=60, device="cpu")
    before = split_tree.launches
    arrays = part.tree.device_arrays("cpu")
    got = split_tree.descend_batch(torch.as_tensor(X), *arrays,
                                   int(part.tree.root))
    assert split_tree.launches == before      # no launch on the CPU
    np.testing.assert_array_equal(got.numpy(), part.gid)
