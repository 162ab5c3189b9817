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


def _packed(tree, T):
    return split_tree.descend_batch_packed_plain(
        torch.as_tensor(np.asarray(T, np.float64)),
        tree.device_packed("cpu")).numpy()


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
    assert _packed(leaf, T).shape == (0,)
    np.testing.assert_array_equal(_plain(leaf, np.ones((4, 3))),
                                  np.zeros(4, np.int64))
    np.testing.assert_array_equal(_packed(leaf, np.ones((4, 3))),
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
    packed = part.tree.device_packed("cpu")
    got = split_tree.descend_batch(torch.as_tensor(X), packed)
    assert split_tree.launches == before      # no launch on the CPU
    np.testing.assert_array_equal(got.numpy(), part.gid)


# ----------------------------------------- the kernel's packed layout (CPU)


def test_packed_mirror_matches_every_reference_descent(fitted):
    """``descend_batch_packed_plain`` (the kernel's walk over the packed
    layout) gives the reference's host, jitted and scalar leaves on every
    backend's tree, the merged bound-less tree and a single leaf."""
    name, ref, port, data = fitted
    finite, nan = _probes(data, port.tree, seed=3)
    for T in (finite, nan, data):
        want = ref.tree.descend_batch(T)
        np.testing.assert_array_equal(
            np.asarray(ref.tree.descend_batch_jax(T)), want, err_msg=name)
        np.testing.assert_array_equal(_packed(port.tree, T), want,
                                      err_msg=name)
    scalar = np.fromiter((ref.tree.descend(t) for t in finite), np.int64,
                         len(finite))
    np.testing.assert_array_equal(_packed(port.tree, finite), scalar,
                                  err_msg=name)
    np.testing.assert_array_equal(_packed(port.tree, data), port.gid,
                                  err_msg=name)


# (attribute, bound count) a node of the hand-made tree: 20 (two whole
# lines and one of 4), 8 (one line), 1, 0 (bound-less), 16 (two whole
# lines), 9 (a line of one), 2, 24, 9 with ties among its bounds, 17, 80
# (10 lines: two rounds of fences) and 137 (18 lines, three rounds)
SHAPES = {0: (0, 20), 1: (1, 8), 2: (1, 1), 3: (1, 0), 4: (2, 16),
          5: (2, 9), 6: (1, 2), 7: (1, 24), 8: (2, 9), 9: (2, 17),
          10: (1, 80), 11: (2, 137)}
# (parent, child position) of each inner node but the root: the positions
# sit at line edges (8: a line's last child, 9: the next line's first)
EDGES = {1: (0, 3), 2: (0, 8), 3: (0, 9), 4: (0, 16), 5: (0, 17),
         6: (0, 20), 7: (0, 0), 8: (1, 0), 9: (2, 1), 10: (0, 5),
         11: (10, 70)}


def _hand_tree(dupes: bool):
    """A split tree over 3 attributes whose nodes have the bound counts of
    ``SHAPES``; node 8's bounds hold equal neighbours when ``dupes``."""
    rng = np.random.default_rng(11)
    n = len(SHAPES)
    attr = np.array([SHAPES[i][0] for i in range(n)], np.int32)
    nb = np.array([SHAPES[i][1] for i in range(n)], np.int64)
    bound_off = np.concatenate([[0], np.cumsum(nb)]).astype(np.int64)
    bounds = np.concatenate([np.sort(rng.choice(1000, b, replace=False))
                             / 10.0 - 50.0 for b in nb])
    if dupes:
        s = bound_off[8]
        bounds[s + 2] = bounds[s + 1]
        bounds[s + 5] = bounds[s + 6] = bounds[s + 4]
    children = np.zeros(len(bounds) + n, np.int64)
    gid = 0
    for i in range(n):
        for p in range(nb[i] + 1):
            children[bound_off[i] + i + p] = ~gid
            gid += 1
    for node, (par, p) in EDGES.items():
        children[bound_off[par] + par + p] = node
    # node 9's leaves in descending order: all leaves, but no run
    s9 = bound_off[9] + 9
    children[s9:s9 + nb[9] + 1] = children[s9:s9 + nb[9] + 1][::-1]
    return attr, bound_off, bounds, children, 0


def _route_rows(tree, rng, per_value=3):
    """Rows that reach each node and hold there, in its attribute, each of
    its bounds (ties, at every fence and inside every line), the doubles
    next to them, NaN, +-inf and values beyond its ends; the other
    attributes random."""
    path = {0: []}
    for node in sorted(EDGES):
        par, p = EDGES[node]
        b = tree.bounds[tree.bound_off[par]:tree.bound_off[par + 1]]
        v = b[p - 1] if p else b[0] - 1.0
        path[node] = path[par] + [(int(tree.attr[par]), v)]
    rows = []
    for node, steps in path.items():
        b = tree.bounds[tree.bound_off[node]:tree.bound_off[node + 1]]
        vals = np.concatenate([b, np.nextafter(b, -np.inf),
                               np.nextafter(b, np.inf),
                               [np.nan, np.inf, -np.inf, -1e300, 1e300]])
        for v in vals:
            r = rng.uniform(-60, 60, (per_value, 3))
            for a, u in steps:
                r[:, a] = u
            r[:, tree.attr[node]] = v
            rows.append(r)
    return np.concatenate(rows)


@pytest.mark.parametrize("dupes", [False, True], ids=["distinct", "ties"])
def test_packed_mirror_ties_at_fences_and_inside_lines(dupes):
    """A hand-made tree with nodes of 0, 1, 2, 8, 9, 16, 17, 20, 24, 80
    and 137 bounds: every bound as a value (ties at each fence and inside
    each line, of a line of one and a whole line, in each round of fences),
    the doubles beside it, NaN and +-inf, against the reference's host,
    jitted and scalar descents."""
    arrays = _hand_tree(dupes)
    ref = ref_partitioner.SplitTree(*arrays)
    port = SplitTree(*arrays)
    packed = port.device_packed("cpu")
    assert packed.depth == 3
    T = _route_rows(port, np.random.default_rng(2))
    want = ref.descend_batch(T)
    np.testing.assert_array_equal(np.asarray(ref.descend_batch_jax(T)),
                                  want)
    np.testing.assert_array_equal(_packed(port, T), want)
    np.testing.assert_array_equal(_plain(port, T), want)
    ok = ~np.isnan(T).any(axis=1)
    scalar = np.fromiter((ref.descend(t) for t in T[ok]), np.int64,
                         int(ok.sum()))
    np.testing.assert_array_equal(_packed(port, T[ok]), scalar)
    # every leaf is reached but the 3 between node 8's equal bounds
    assert len(np.unique(want)) == len(arrays[2]) + len(SHAPES) \
        - len(EDGES) - 3 * dupes


def test_packed_layout_holds_the_tree():
    """Records, fences and lines of the hand-made tree, breadth first: each
    node's attribute, bound count, first child, second child or first
    line, whether its children are a run of leaves; its fences (bounds 0,
    8, 16, ...); each line's bounds 1..7 in the kernel's order (NaN past
    the node's last) and the children they select."""
    attr, bound_off, bounds, children, root = _hand_tree(False)
    p = SplitTree(attr, bound_off, bounds, children, root) \
        .device_packed("cpu")
    recs = p.recs.numpy().astype(np.int64)
    meta = recs[:, 0] & 0xFFFFFFFF
    lb, lc = p.lines, p.kids.numpy()
    fences = p.fences.numpy()
    order = [0, 7, 1, 10, 2, 3, 4, 5, 6, 8, 11, 9]   # breadth first
    np.testing.assert_array_equal((meta >> 8) & 0x7FFFFF,
                                  [SHAPES[i][1] for i in order])
    new = {old: i for i, old in enumerate(order)}
    for i, old in enumerate(order):
        b = bounds[bound_off[old]:bound_off[old + 1]]
        c = children[bound_off[old] + old:bound_off[old + 1] + old + 1]
        c = np.array([new[x] if x >= 0 else x for x in c])
        assert meta[i] & 0xFF == attr[old]
        assert recs[i, 1] == c[0]
        # leaf runs: every node without inner children but node 9
        assert bool(meta[i] >> 31) == (old not in (0, 1, 2, 9, 10)), old
        if meta[i] >> 31:
            np.testing.assert_array_equal(c, c[0] - np.arange(len(c)))
        np.testing.assert_array_equal(
            fences[recs[i, 3]:recs[i, 3] + -(-len(b) // 8)], b[::8])
        if len(b) == 1:
            assert recs[i, 2] == c[1]
        for L in range(-(-len(b) // 8) if len(b) >= 2 else 0):
            line = recs[i, 2] + L
            got = lb[line].numpy()
            want = np.array([b[8 * L + s] if s >= 0 and 8 * L + s < len(b)
                             else np.nan for s in split_tree.LINE_ORDER])
            np.testing.assert_array_equal(got, want)
            seg = c[8 * L + 1:8 * L + 9]
            np.testing.assert_array_equal(lc[line, :len(seg)], seg)
    assert p.fences.numel() == sum(-(-b // 8) for _, b in SHAPES.values())
    assert p.lines.shape[0] == sum(-(-b // 8) for _, b in SHAPES.values()
                                   if b >= 2)


def test_packed_layout_is_built_once_per_tree_and_device(X, monkeypatch):
    import threading
    part = partitioner.fit(X, backend="kdtree", d_f=60, device="cpu")
    tree = SplitTree(part.tree.attr, part.tree.bound_off, part.tree.bounds,
                     part.tree.children, part.tree.root)
    made = []
    real = split_tree.pack_tree
    monkeypatch.setattr(split_tree, "pack_tree",
                        lambda *a, **kw: made.append(1) or real(*a, **kw))
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        tree.device_packed("cpu"))) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(made) == 1 and all(g is got[0] for g in got)
    assert tree.device_arrays("cpu") is got[0].arrays
    tree.descend_batch_device(X[:100], "cpu")
    tree.device_packed(torch.device("cpu"))
    assert len(made) == 1


def _broken(fault):
    """The hand-made tree with one fault, and what the error names."""
    attr, bound_off, bounds, children, root = _hand_tree(False)
    s, n = bound_off[4], len(children)
    if fault == "unsorted":
        bounds[s + 3], bounds[s + 4] = bounds[s + 4], bounds[s + 3]
    elif fault == "nan":
        bounds[s + 11] = np.nan
    elif fault == "children too long":
        children = np.concatenate([children, [~0]])
    elif fault == "children too short":
        children = children[:-1]
    elif fault == "child beyond the nodes":
        children[bound_off[3] + 3] = len(attr)
    elif fault == "root beyond the nodes":
        root = len(attr)
    elif fault == "bound offsets short":
        bound_off = bound_off[:-1]
    elif fault == "bound offsets fall":
        bound_off[5], bound_off[6] = bound_off[6], bound_off[5]
    elif fault == "bound offsets miss the end":
        bound_off = bound_off.copy()
        bound_off[-1] -= 1
    return SplitTree(attr, bound_off, bounds, children, root), {
        "unsorted": "node 4 ", "nan": "node 4 ",
        "children too long": f"need {n} children, got {n + 1}",
        "children too short": f"need {n} children, got {n - 1}",
        "bound offsets short": "need 13 bound offsets",
        "bound offsets fall": "must rise",
        "bound offsets miss the end": "must rise"}.get(fault, "beyond")


@pytest.mark.parametrize("fault", [
    "unsorted", "nan", "children too long", "children too short",
    "child beyond the nodes", "root beyond the nodes", "bound offsets short",
    "bound offsets fall", "bound offsets miss the end"])
def test_packed_layout_refuses_unsorted_or_nan_bounds(fault):
    """A node whose bounds descend or hold a NaN, or arrays that are not
    one tree's (children one too many or too few, a child or the root
    beyond the nodes, offsets short, falling or off the bound count):
    building the packed layout raises a ValueError naming the fault;
    nothing falls back."""
    tree, what = _broken(fault)
    with pytest.raises(ValueError, match=what):
        tree.device_packed("cpu")
    with pytest.raises(ValueError, match=what):
        tree.device_arrays("cpu")
    with pytest.raises(ValueError, match=what):
        tree.descend_batch_device(np.zeros((3, 3)), "cpu")


def test_packed_layout_takes_a_drop_between_nodes():
    """Bounds fall from one node's last to the next node's first: that is
    no fault."""
    attr, bound_off, bounds, children, root = _hand_tree(False)
    bounds[bound_off[1]:bound_off[2]] -= 1000.0
    tree = SplitTree(attr, bound_off, bounds, children, root)
    T = _route_rows(tree, np.random.default_rng(4))
    np.testing.assert_array_equal(_packed(tree, T), tree.descend_batch(T))


@pytest.mark.parametrize("budget", [0, 40, 1000, 10_000, 10**7])
def test_staging_prefixes_fit_their_budget(fitted, budget):
    """The plan's staged records, lines and fences are prefixes within
    the budget: records first, fences once every record is in, lines once
    every fence is in; the name says which."""
    _, _, port, _ = fitted
    p = port.tree.device_packed("cpu")
    r, w, f, name = split_tree.plan(p, budget)
    n, F, W = p.num_nodes, p.fences.numel(), p.lines.shape[0]
    assert r * 16 + w * 64 + f * 8 <= budget
    if p.root < 0:
        assert (r, w, f, name) == (0, 0, 0, "unstaged")
        return
    assert r == min(n, budget // 16)
    assert f == 0 or r == n
    assert w == 0 or f == F
    assert name == ("whole" if (r, f, w) == (n, F, W) else
                    "records+fences" if (r, f) == (n, F) else
                    "records" if r == n else "records prefix")
