"""The port's training substrate against the JAX reference, on the CPU:
checkpoints (and checkpoints crossing between the packages both ways),
the fleet coordinator, the token pipeline and the package-query data
selection (mirrors ``tests/test_substrates.py``)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from repro.checkpoint import CheckpointManager as RefManager
from repro.configs import get_config as ref_config
from repro.data import pipeline as ref_pipeline
from repro.data import selection as ref_selection
from repro.models import Model as RefModel
from repro.runtime import Coordinator as RefCoordinator
from repro.runtime import WorkerState as RefWorkerState
from repro.training.optimizer import OptHyper as RefHyper
from repro.training.step import init_train_state as ref_init_state
from repro.training.step import make_train_step as ref_make_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import pipeline, selection
from repro_torch.models.convert import from_jax_train_state
from repro_torch.runtime import Coordinator, WorkerState


# ------------------------------------------------------------ checkpoint


def _state():
    return {"params": {"w": torch.arange(12, dtype=torch.bfloat16)
                       .reshape(3, 4),
                       "b": torch.ones(3, dtype=torch.float32)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _leaves(tree):
    """Leaves of nested dicts in sorted-key order (JAX's dict order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _bits(x) -> np.ndarray:
    """A leaf of either package as numpy, bf16 as its 16 bits."""
    if torch.is_tensor(x):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _assert_bit_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert _dtype_name(a) == _dtype_name(b)
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    st = _state()
    mgr.save(7, st)
    out = mgr.restore(st)
    _assert_bit_equal(out, st)
    assert out["opt"]["step"].shape == ()


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last_k=2)
    st = _state()
    for s in (5, 10, 15, 20):
        mgr.save(s, st)
    assert mgr.all_steps() == [15, 20]
    assert mgr.latest_step() == 20


def test_checkpoint_atomicity(tmp_path):
    """A stale tmp dir (simulated crash mid-save) never corrupts restore."""
    mgr = CheckpointManager(str(tmp_path))
    st = _state()
    mgr.save(1, st)
    os.makedirs(os.path.join(str(tmp_path), ".tmp_step_000002_999"),
                exist_ok=True)  # crashed half-written save
    assert mgr.latest_step() == 1
    _assert_bit_equal(mgr.restore(st), st)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    with W.world1(tmp_path_factory.mktemp("world1") / "store"):
        yield


def test_checkpoint_restore_with_device_placements(tmp_path):
    """Elastic restore: every leaf lands on the device given for it."""
    mgr = CheckpointManager(str(tmp_path))
    st = _state()
    mgr.save(3, st)
    sh = {"params": {"w": torch.device("cpu"), "b": torch.device("cpu")},
          "opt": {"step": torch.device("cpu")}}
    out = mgr.restore(st, sharding=sh)
    assert all(t.device == torch.device("cpu") for t in _leaves(out))
    _assert_bit_equal(out, st)


def test_checkpoint_restore_onto_a_mesh(tmp_path, world1):
    """Elastic restore onto a 1-rank gloo ``DeviceMesh``: every leaf a
    ``DTensor`` replicated on it, with the saved values."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    mgr = CheckpointManager(str(tmp_path))
    st = _state()
    mgr.save(3, st)
    place = (mesh, (Replicate(),))
    sh = {"params": {"w": place, "b": place}, "opt": {"step": place}}
    out = mgr.restore(st, sharding=sh)
    for t in _leaves(out):
        assert isinstance(t, DTensor)
        assert t.device_mesh == mesh and tuple(t.placements) == (Replicate(),)
    _assert_bit_equal({k: {n: t.full_tensor() for n, t in v.items()}
                       for k, v in out.items()}, st)


def test_checkpoint_restore_checks_paths_and_shapes(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    st = _state()
    mgr.save(1, st)
    renamed = {"params": {"w": st["params"]["w"], "c": st["params"]["b"]},
               "opt": st["opt"]}
    with pytest.raises(ValueError, match="params/b"):
        mgr.restore(renamed)
    reshaped = {"params": {"w": st["params"]["w"].reshape(4, 3),
                           "b": st["params"]["b"]}, "opt": st["opt"]}
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(reshaped)
    with pytest.raises(ValueError, match="mismatch"):
        mgr.restore({"params": st["params"]})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(st)


def test_checkpoint_restore_from_abstract_like(tmp_path):
    """A ``like`` on the ``meta`` device (no storage) restores to the CPU."""
    mgr = CheckpointManager(str(tmp_path))
    st = _state()
    mgr.save(2, st)
    like = {k: {n: torch.empty(t.shape, dtype=t.dtype, device="meta")
                for n, t in v.items()} for k, v in st.items()}
    _assert_bit_equal(mgr.restore(like), st)


# ------------------------------------------------- across the two packages


def _ref_toy():
    return {"params": {"w": jnp.arange(12, dtype=jnp.bfloat16).reshape(3, 4),
                       "b": jnp.ones(3, jnp.float32)},
            "opt": {"step": jnp.int32(7)}}


def _manifest(root, step):
    with open(os.path.join(root, f"step_{step:06d}", "manifest.json")) as f:
        m = json.load(f)
    m.pop("time")
    return m


@pytest.fixture(scope="module", params=[False, True], ids=["adamw", "ef"])
def smoke_states(request):
    """(the reference's train state after one step, as numpy; the port's
    state over a model holding it, by ``from_jax_train_state``) of
    smollm-135m-smoke in its own dtypes (bf16 parameters, float32
    moments), with and without the error-feedback residual."""
    compress = request.param
    rc = ref_config("smollm-135m-smoke")
    ref = RefModel(rc)
    state = ref_init_state(ref, jax.random.PRNGKey(0), compress=compress)
    rng = np.random.default_rng(0)
    tok = jnp.asarray(rng.integers(1, rc.vocab_size, (2, 32)), jnp.int32)
    state, _ = jax.jit(ref_make_step(ref, RefHyper(lr=1e-3),
                                     compress=compress))(
        state, {"tokens": tok, "labels": tok})
    state = jax.tree.map(np.asarray, state)
    cfg = get_config("smollm-135m-smoke")
    _, port_state = from_jax_train_state(state, cfg, "cpu")
    return state, port_state


def test_toy_checkpoint_crosses_both_ways(tmp_path):
    """The port restores the reference's checkpoint and the reference the
    port's, every leaf bit-equal; the two manifests are the same."""
    ref_root, port_root = str(tmp_path / "ref"), str(tmp_path / "port")
    RefManager(ref_root).save(7, _ref_toy())
    CheckpointManager(port_root).save(7, _state())
    assert _manifest(port_root, 7) == _manifest(ref_root, 7)
    _assert_bit_equal(CheckpointManager(ref_root).restore(_state()),
                      _state())
    _assert_bit_equal(RefManager(port_root).restore(_ref_toy()), _ref_toy())


def test_train_state_checkpoint_crosses_both_ways(tmp_path, smoke_states):
    """A smollm-135m-smoke train state after a step (non-zero moments and,
    with ``ef``, residual; bf16 parameters; the 0-d int32 step): saved by
    either package, restored by the other, every leaf bit-equal, and the
    manifests the same (paths, files, dtypes, shapes, treedef)."""
    ref_state, port_state = smoke_states
    ref_root, port_root = str(tmp_path / "ref"), str(tmp_path / "port")
    RefManager(ref_root).save(1, jax.tree.map(jnp.asarray, ref_state))
    CheckpointManager(port_root).save(1, port_state)
    assert _manifest(port_root, 1) == _manifest(ref_root, 1)
    got = CheckpointManager(ref_root).restore(port_state)
    _assert_bit_equal(got, port_state)
    _assert_bit_equal(got, ref_state)
    back = RefManager(port_root).restore(jax.tree.map(jnp.asarray,
                                                      ref_state))
    _assert_bit_equal(jax.tree.map(np.asarray, back), ref_state)
    assert got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == 1
    assert ("ef" in got["opt"]) == ("ef" in ref_state["opt"])


# ------------------------------------------------------------ coordinator


def _heartbeat_failure(C, S):
    co = C(4, heartbeat_timeout_s=10)
    for w in range(4):
        co.heartbeat(w, t=0.0)
    co.check_health(t=5.0)
    trace = [len(co.healthy_workers())]
    co.heartbeat(0, 12.0)
    co.heartbeat(1, 12.0)
    co.heartbeat(2, 12.0)      # worker 3 silent
    co.check_health(t=12.0)
    assert co.workers[3].state == S.FAILED
    assert co.phase.value == "reshaping"
    return co, trace


def _straggler_escalation(C, S):
    co = C(2, straggler_strikes=2)
    for i in range(10):
        co.report_step(0, t=i, step_time_s=1.0)
        co.report_step(1, t=i, step_time_s=1.0)
    co.report_step(1, t=11, step_time_s=5.0)
    assert co.workers[1].state == S.STRAGGLER
    trace = [co.workers[1].state.value]
    co.report_step(1, t=12, step_time_s=5.0)
    assert co.workers[1].state == S.FAILED
    return co, trace


def _elastic_plan(C, S):
    co = C(16)
    for w in (3, 7, 11):
        co._fail(co.workers[w], 0.0, "test")
    dp, members = co.plan_mesh(global_batch=256)
    assert dp <= 13 and 256 % dp == 0
    assert dp == 8           # largest power-of-two <= 13 dividing 256
    plan = co.resume_plan(256)
    assert plan["restore_latest_checkpoint"]
    return co, [dp, members, plan, co.plan_mesh(global_batch=12)]


def _adaptive_cadence(C, S):
    co = C(2, ckpt_cadence_steps=100, min_cadence=10, stable_steps=5)
    assert co.cadence == 100
    co._fail(co.workers[0], 0.0, "test")
    assert co.cadence == 50
    trace = [co.cadence]
    for i in range(5):
        co.report_step(1, t=i, step_time_s=1.0)
        trace.append((co.cadence, co.should_checkpoint(i * 25)))
    assert co.cadence == 100
    return co, trace


@pytest.mark.parametrize("case", [_heartbeat_failure, _straggler_escalation,
                                  _elastic_plan, _adaptive_cadence],
                         ids=lambda f: f.__name__.strip("_"))
def test_coordinator_decides_as_the_reference(case):
    """Each of the reference's four cases on the same virtual clock: the
    reference's assertions hold for the port, and every decision (worker
    states and strikes, phase, cadence, restores, the event log, the
    mesh plans) equals the reference's."""
    got, got_trace = case(Coordinator, WorkerState)
    want, want_trace = case(RefCoordinator, RefWorkerState)

    def decisions(co):
        return ([(w.wid, w.state.value, w.slow_strikes, w.last_heartbeat)
                 for w in co.workers.values()],
                co.phase.value, co.cadence, co.restores,
                co.clean_steps_since_failure,
                [(e.t, e.kind, e.detail) for e in co.events])
    assert decisions(got) == decisions(want)
    assert got_trace == want_trace


# ------------------------------------------------------------------ data


@pytest.mark.parametrize("seed, step", [(0, 0), (1, 3), (2, 17), (7, 1000)])
def test_pipeline_is_the_reference_bit_for_bit(seed, step):
    """``global_batch`` and every ``shard_batch`` equal the reference's
    (int32, bit for bit); shards reassemble the global batch, which is
    reproducible."""
    kw = dict(vocab_size=512, seq_len=32, global_batch=8, seed=seed)
    d = pipeline.SyntheticTokens(pipeline.DataConfig(**kw))
    r = ref_pipeline.SyntheticTokens(ref_pipeline.DataConfig(**kw))
    g, want = d.global_batch(step), r.global_batch(step)
    assert set(g) == set(want) == {"tokens", "labels"}
    for k in want:
        assert g[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(g[k], want[k])
    for num in (2, 4):
        parts = [d.shard_batch(step, s, num) for s in range(num)]
        for s, p in enumerate(parts):
            for k in want:
                np.testing.assert_array_equal(
                    p[k], r.shard_batch(step, s, num)[k])
        np.testing.assert_array_equal(
            np.concatenate([p["tokens"] for p in parts]), g["tokens"])
    np.testing.assert_array_equal(d.global_batch(step)["tokens"],
                                  g["tokens"])


def _reference_case(mod):
    corpus = mod.synth_corpus(mod.CorpusSpec(num_docs=8000, seed=2))
    q = mod.selection_query(corpus, token_budget=1.5e6,
                            domain_caps={"web": 9e5}, dup_budget=40.0)
    return corpus, q


def test_package_query_data_selection():
    """The reference's case through the port on the CPU."""
    corpus, q = _reference_case(selection)
    res = selection.select_training_docs(corpus, q, d_f=20, alpha=1500,
                                         device="cpu")
    assert res.feasible
    assert q.check_package(corpus, res.idx, res.mult)
    toks = corpus["tokens"][res.idx].sum()
    assert 1.425e6 - 1 <= toks <= 1.5e6 + 1
    assert corpus["tok_web"][res.idx].sum() <= 9e5 + 1


def test_data_selection_matches_reference():
    """The same corpus and query as the reference's, and the reference's
    package: the port's layer LPs run through its device twin (plain
    versions on the CPU), so the bar is the engine's device-LP bar
    (``tests/test_torch_engine.py``: objective 1e-6 relative, a valid
    package under both packages' queries); the package itself is the
    reference's here."""
    corpus, q = _reference_case(selection)
    ref_corpus, ref_q = _reference_case(ref_selection)
    assert list(corpus) == list(ref_corpus)
    for k in ref_corpus:
        np.testing.assert_array_equal(corpus[k], ref_corpus[k])
    assert [(c.attr, c.lo, c.hi) for c in q.constraints] == \
        [(c.attr, c.lo, c.hi) for c in ref_q.constraints]
    got = selection.select_training_docs(corpus, q, d_f=20, alpha=1500,
                                         device="cpu")
    want = ref_selection.select_training_docs(ref_corpus, ref_q, d_f=20,
                                              alpha=1500)
    assert got.feasible and want.feasible
    assert got.obj == pytest.approx(want.obj, rel=1e-6)
    assert q.check_package(corpus, got.idx, got.mult)
    assert ref_q.check_package(ref_corpus, got.idx, got.mult)
    np.testing.assert_array_equal(got.idx, want.idx)
    np.testing.assert_array_equal(got.mult, want.mult)


def test_data_selection_needs_cuda_unless_asked():
    corpus, q = _reference_case(selection)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        selection.select_training_docs(corpus, q, d_f=20, alpha=1500)
