"""The port's sharding rules (``repro_torch.distributed.sharding``)
against the reference's (``repro.distributed.sharding``).

Placement parity is exact: every parameter leaf of the ten archs and
every cache leaf of their decode cells get the reference's spec on the
production meshes (16 x 16 and 2 x 16 x 16, abstract: names and sizes,
no process group).  Then the reference's own sharding cases
(``tests/test_sharding.py``) on the port's rules, the DTensor placements
of tuple entries, and the MoE group sizes by data-parallel size against
the reference's ``apply_moe`` traced with ``jax.eval_shape``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest

from repro.configs import get_config as ref_config
from repro.distributed import context as ref_context
from repro.distributed.sharding import make_rules as ref_make_rules
from repro.launch.mesh import make_abstract_mesh as ref_abstract_mesh
from repro.models import Model as RefModel
from repro.models import moe as ref_moe
from repro.models.param import abstract_params as ref_abstract_params
from repro_torch.configs import (ARCH_IDS, SHAPES, get_config,
                                 shape_applicable)
from repro_torch.distributed.sharding import (FSDP_MIN_SIZE, TP_PRIORITY,
                                              P, cache_kind, make_rules)
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.launch.specs import cache_shapes
from repro_torch.models import moe
from repro_torch.models.model import Model

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _rules(mesh):
    shape, axes = MESHES[mesh]
    return (make_rules(make_abstract_mesh(shape, axes)),
            ref_make_rules(ref_abstract_mesh(shape, axes)))


def _ref_leaves(arch):
    """{dotted name: (shape, axes)} of the reference's parameters."""
    m = RefModel(ref_config(arch))
    flat = jax.tree.flatten_with_path(m.abstract_params())[0]
    axes = jax.tree.leaves(m.axes(), is_leaf=lambda x: isinstance(x, tuple)
                           and all(isinstance(e, (str, type(None)))
                                   for e in x))
    return {".".join(str(getattr(k, "key", k)) for k in path):
            (tuple(leaf.shape), ax) for (path, leaf), ax in zip(flat, axes)}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_equal_the_reference(arch, mesh):
    rules, ref = _rules(mesh)
    want = _ref_leaves(arch)
    got = Model(get_config(arch), device="cpu").axes()
    assert set(got) == set(want)
    for name, (shape, axes) in want.items():
        assert got[name] == tuple(axes), name
        assert tuple(rules.param_pspec(shape, axes)) == \
            tuple(ref.param_pspec(shape, axes)), (arch, mesh, name)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_equal_the_reference(arch, mesh):
    rules, ref = _rules(mesh)
    n = 0
    for shape_name in ("decode_32k", "long_500k"):
        shape = SHAPES[shape_name]
        if not shape_applicable(get_config(arch), shape)[0]:
            continue
        B, S = shape.global_batch, shape.seq_len
        want = RefModel(ref_config(arch)).init_cache(B, S, abstract=True)
        got = cache_shapes(Model(get_config(arch), device="cpu"), B, S)
        assert set(got) == set(want) - {"index"}
        for key, (shp, _) in got.items():
            assert shp == tuple(want[key].shape), (key, shp)
            kind = cache_kind(key)
            assert tuple(rules.cache_pspec(shp, kind)) == \
                tuple(ref.cache_pspec(shp, kind)), (arch, shape_name, key)
            n += 1
    assert n > 0


# ------------------------------------------- the reference's own cases


@pytest.fixture(scope="module")
def rules16():
    return _rules("16x16")[0]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_valid_for_all_archs(arch, rules16):
    """Every param gets a spec whose sharded dims divide exactly, with no
    mesh axis used twice (``tests/test_sharding.py``)."""
    n_tp = 0
    sizes = rules16.sizes
    for _, (shape, axes) in _ref_leaves(arch).items():
        spec = rules16.param_pspec(shape, axes)
        used = []
        for dim, entry in zip(shape, spec):
            if entry is None:
                continue
            entries = entry if isinstance(entry, tuple) else (entry,)
            for e in entries:
                used.append(e)
                assert dim % sizes[e] == 0, (arch, shape, axes, spec)
            n_tp += "model" in entries
        assert len(used) == len(set(used)), (arch, spec)
    assert n_tp > 0, f"{arch}: no parameter is tensor-parallel"


def test_fsdp_shards_large_params(rules16):
    assert tuple(rules16.param_pspec((1024, 4096), ("embed", "mlp"))) == \
        ("data", "model")


def test_small_params_stay_replicated(rules16):
    assert tuple(rules16.param_pspec((576,), ("embed",))) == (None,)
    assert FSDP_MIN_SIZE == 1 << 16 and TP_PRIORITY[0] == "vocab"


def test_nondivisible_dims_fall_back(rules16):
    spec = rules16.param_pspec((576, 9, 64), ("embed", "heads", "head"))
    for dim, entry in zip((576, 9, 64), spec):
        for e in (entry if isinstance(entry, tuple) else (entry,)):
            assert e is None or dim % rules16.sizes[e] == 0


def test_cache_pspecs(rules16):
    spec = rules16.cache_pspec((40, 128, 32768, 2, 128), "kv")
    assert spec[1] == "data" and spec[2] == "model"
    spec = rules16.cache_pspec((48, 1, 524288, 8, 64), "kv")
    assert spec[1] is None
    assert "model" in spec[2] and "data" in spec[2]


def test_shape_applicability_matrix():
    """The 40-cell matrix: 34 runnable + 6 documented long_500k skips."""
    runnable = skipped = 0
    for arch in ARCH_IDS:
        for s in SHAPES.values():
            ok, why = shape_applicable(get_config(arch), s)
            runnable += ok
            skipped += not ok
            assert ok or (s.name == "long_500k" and why)
    assert runnable == 34 and skipped == 6


def test_batch_and_dp_entries_equal_the_reference():
    for mesh in MESHES:
        rules, ref = _rules(mesh)
        assert rules.dp_size == ref.dp_size and rules.tp_size == ref.tp_size
        for b in (1, 2, 16, 32, 48, 128, 256, 512, 1000):
            assert rules._dp_entry(b) == ref._dp_entry(b), (mesh, b)
            assert tuple(rules.batch_pspec(b, 2)) == \
                tuple(ref.batch_pspec(b, 2))


# ----------------------------------------------------------- placements


def test_placements_of_tuple_entries():
    from torch.distributed.tensor import Replicate, Shard
    rules = _rules("2x16x16")[0]
    assert rules.placements(P(("pod", "data"), None, "model")) == \
        [Shard(0), Shard(0), Shard(2)]
    assert rules.placements(P(None, None, ("pod", "data", "model"))) == \
        [Shard(2)] * 3
    assert rules.placements(P(None, "data")) == \
        [Replicate(), Shard(1), Replicate()]
    assert rules.placements(P()) == [Replicate()] * 3
    with pytest.raises(ValueError, match="axis order"):
        rules.placements(P(("model", "data"),))
    with pytest.raises(ValueError, match="twice"):
        rules.placements(P("data", "data"))
    one = make_rules(make_abstract_mesh((1, 4), ("data", "model")))
    # a mesh dim of size 1 holds the whole tensor: replicated
    assert one.placements(P("data", "model")) == [Replicate(), Shard(1)]


def test_explain_words_every_leaf():
    rules = _rules("16x16")[0]
    m = Model(get_config("smollm-135m"), device="cpu")
    from repro_torch.models.param import leaves
    out = rules.explain(leaves(m.spec()))
    assert set(out) == set(m.axes())
    assert out["embed.embedding"].endswith("-> P('model', 'data')")


# --------------------------------------------------------- MoE groups


def _ref_group_shape(T: int, dp: int):
    """(G, g) of the reference's ``apply_moe`` on T tokens under rules of
    data-parallel size ``dp``, traced with ``jax.eval_shape``."""
    cfg = dataclasses.replace(ref_config("mixtral-8x22b").smoke(),
                              param_dtype="float32")
    p = ref_abstract_params(ref_moe.moe_spec(cfg), jnp.float32)
    seen = []

    class Rules:
        dp_size = dp
        replicate_decode_activations = False

    def record(x, spec):
        seen.append(tuple(x.shape))
        return x

    mp = pytest.MonkeyPatch()
    mp.setattr(ref_context, "current_rules", lambda: Rules())
    mp.setattr(ref_moe, "constrain", record)
    try:
        jax.eval_shape(lambda p, x: ref_moe.apply_moe(p, cfg, x), p,
                       jax.ShapeDtypeStruct((1, T, cfg.d_model),
                                            jnp.float32))
    finally:
        mp.undo()
    return seen[0][:2]


@pytest.mark.parametrize("T", [1, 7, 512, 1000, 1024, 4096, 6144, 20000,
                               1 << 20])
def test_moe_group_sizes_equal_the_reference(T):
    for dp in (1, 2, 3, 16, 256, 512):
        G, g = _ref_group_shape(T, dp)
        assert moe.tokens_per_group(T, 4096, dp) == g, (T, dp)
        assert T // g == G
