"""Multi-rank bodies of the port's distributed tests, on ``gloo`` (CPU).

Imports numpy, torch and ``repro_torch`` only, so the ranks that
:func:`spawn` starts never import JAX; pytest does not collect it (no
``test_`` prefix).  A world of one rank runs in the test process
(:func:`world1`); worlds of 2 and 4 are spawned once per test module,
each rank running every case of the module in one process group and
writing its results under the module's temporary directory.

A case is ``(name, kind, kwargs)``: :data:`CASES` maps ``kind`` to a
function of ``(mesh, **kwargs)`` that returns a dict of numpy values;
``kwargs["mesh"]`` names the mesh as ``(shape, dim names)`` (default
:data:`MESHES`' entry for the world).
"""
from __future__ import annotations

import contextlib
import datetime
import functools
import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 120          # every process group's collective timeout
JOIN_S = 180             # a spawned world's limit, start to last join
NAMES = ("data", "model")
MESHES = {1: (1, 1), 2: (1, 2), 4: (2, 2)}   # the pricing tests' meshes


_MESHES: dict = {}       # (shape, names) -> DeviceMesh of the live group


def _init(store_path: str, rank: int, world: int) -> None:
    _MESHES.clear()
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(store_path), world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))


@contextlib.contextmanager
def world1(store_path):
    """An in-process gloo world of one rank (``FileStore`` at
    ``store_path``), destroyed on exit; one that is already up (another
    module's, still alive) is used as it is and left up."""
    mine = not dist.is_initialized()
    if mine:
        _init(store_path, 0, 1)
    elif dist.get_world_size() != 1:
        raise RuntimeError("a process group of more than one rank is up")
    try:
        yield
    finally:
        if mine:
            _MESHES.clear()
            dist.destroy_process_group()


def mesh(shape=None, names=NAMES):
    """A CPU ``DeviceMesh`` over the current world (default: the world's
    entry of :data:`MESHES`), one per shape while the group lives."""
    from torch.distributed.device_mesh import init_device_mesh
    if shape is None:
        shape = MESHES[dist.get_world_size()]
    key = (tuple(shape), tuple(names)[:len(shape)])
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh("cpu", key[0],
                                        mesh_dim_names=key[1])
    return _MESHES[key]


def run(cases) -> dict:
    """Every case on the current world: {name: result dict}."""
    out = {}
    for name, kind, kw in cases:
        kw = dict(kw)
        m = mesh(*kw.pop("mesh", ()))
        out[name] = CASES[kind](m, **kw)
    return out


def _rank_main(rank: int, world: int, store_path: str, cases,
               out_dir: str) -> None:
    torch.set_num_threads(1)
    try:
        _init(store_path, rank, world)
        res = run(cases)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(world: int, cases, out_dir, join_s: float = JOIN_S) -> list:
    """``cases`` on a spawned gloo world of ``world`` ranks: each rank's
    results, in rank order.  Raises with the ranks' tracebacks if one
    fails or the world is not done within ``join_s`` seconds."""
    return join(start(world, cases, out_dir), join_s)


def start(world: int, cases, out_dir):
    """:func:`spawn`'s world started and left running: a handle for
    :func:`join`."""
    import multiprocessing as mp
    out_dir = str(out_dir)
    ctx = mp.get_context("spawn")
    store = os.path.join(out_dir, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, cases, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, out_dir, time.monotonic()


def join(handle, join_s: float = JOIN_S) -> list:
    """The results of a world that :func:`start` started, in rank order,
    once it is done; raises as :func:`spawn` does, ``join_s`` counted
    from the start."""
    procs, out_dir, t0 = handle
    world = len(procs)
    deadline = t0 + join_s
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    errs = [open(os.path.join(out_dir, e)).read()
            for e in sorted(os.listdir(out_dir)) if e.endswith(".err")]
    if hung or errs or any(p.exitcode for p in procs):
        raise RuntimeError(f"world of {world}: {len(hung)} ranks hung, exit "
                           f"codes {[p.exitcode for p in procs]}\n"
                           + "\n".join(errs))
    res = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


# ------------------------------------------------------------------ cases


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def case_step(m, A, d, lo, hi, state, rho, s, budget, **kw):
    """``make_pq_step`` on this rank's shard of full host arrays."""
    from repro_torch.core.distributed import make_pq_step
    step, cols, vec = make_pq_step(m, A.shape[0], A.shape[1], **kw)
    out = step(_t(A[cols]), _t(d[vec]), _t(lo[vec]), _t(hi[vec]),
               _t(state[vec], torch.int32), _t(rho), s, budget)
    names = ("alpha", "flip_mask", "r_best", "q", "d_q", "at_up_q", "Acol",
             "fvec", "n_flips", "has_cross", "exact")
    return {k: _np(v) for k, v in zip(names, out)}


def case_update(m, d, state, alpha, flip, theta, q, leave, leave_up):
    from repro_torch.core.distributed import make_pq_step, make_update_step
    vec = make_pq_step(m, 1, len(d))[2]
    dn, sn = make_update_step(m)(_t(d[vec]), _t(state[vec], torch.int32),
                                 _t(alpha[vec]), _t(flip[vec], torch.bool),
                                 theta, q, leave, leave_up)
    return {"d": _np(dn), "state": _np(sn)}


def case_refresh(m, A, cf, state, lo, hi, y):
    from repro_torch.core.distributed import make_pq_step, make_refresh_step
    _, cols, vec = make_pq_step(m, A.shape[0], A.shape[1])
    d, axn = make_refresh_step(m)(_t(A[cols]), _t(cf[vec]),
                                  _t(state[vec], torch.int32), _t(lo[vec]),
                                  _t(hi[vec]), y)
    return {"d": _np(d), "axn": _np(axn)}


def _lp(res) -> dict:
    return {"status": res.status, "obj": res.obj, "iters": res.iters,
            "basis": np.asarray(res.basis), "x": np.asarray(res.x),
            "at_upper": np.asarray(res.at_upper), "y": np.asarray(res.y),
            "notes": tuple(res.notes),
            "pivot_stats": dict(getattr(res, "pivot_stats", {}))}


def case_solve(m, lp, route=False, **kw):
    """``solve_lp_dist`` (or ``solve_lp(mesh=, device="cpu")`` with
    ``route``) on ``lp = (c, A, bl, bu, ub)``."""
    from repro_torch.core.distributed import solve_lp_dist
    from repro_torch.core.lp import solve_lp
    if route:
        return _lp(solve_lp(*lp, mesh=m, device="cpu", **kw))
    return _lp(solve_lp_dist(*lp, mesh=m, device="cpu", **kw))


def case_shard_fault(m, lp):
    """The reference's SHARD arm (seed 0, one fire) around a solve."""
    from repro_torch.core.distributed import solve_lp_dist
    from repro_torch.runtime import faults
    with faults.injected(seed=0, arms={faults.SHARD: dict(times=1)}) as inj:
        res = solve_lp_dist(*lp, mesh=m, device="cpu")
    return dict(_lp(res), fires=inj.fire_count(faults.SHARD))


def case_group_stats(m, X, order, offsets, chunk_rows):
    from repro_torch.core.partitioner import group_stats
    reps, lo, hi = group_stats(X, order, offsets, mesh=m,
                               chunk_rows=chunk_rows)
    return {"reps": reps, "lo": lo, "hi": hi}


def case_streaming_stats(m, Y, chunk_rows):
    from repro_torch.core.bucketing import ArraySource, streaming_stats
    st = streaming_stats(ArraySource(Y), chunk_rows, mesh=m)
    return {"count": st.count, "mean": st.mean, "var": st.var, "lo": st.lo,
            "hi": st.hi}


def _part(p) -> dict:
    return {"gid": p.gid, "order": p.order, "offsets": p.offsets,
            "reps": p.reps, "lo": p.boxes_lo, "hi": p.boxes_hi}


def case_dlv_bucketed(m, X, d_f, **kw):
    from repro_torch.core.bucketing import ArraySource, dlv_bucketed
    return _part(dlv_bucketed(ArraySource(X), d_f, mesh=m, device="cpu",
                              **kw))


def case_fit(m, X, **kw):
    """``partitioner.fit`` (or ``dlv.dlv_heap`` with ``heap``)."""
    from repro_torch.core import dlv, partitioner
    if kw.pop("heap", False):
        return _part(dlv.dlv_heap(X, mesh=m, device="cpu", **kw))
    return _part(partitioner.fit(X, mesh=m, device="cpu", **kw))


def _layers(h) -> list:
    return [_part(ly.part) for ly in h.layers[1:]]


def case_engine(m, table, attrs, query=None, **kw):
    """``PackageQueryEngine(mesh=).partition()`` and, with ``query``, its
    solve with the layer LPs through ``solve_lp(mesh=)``."""
    from repro_torch.core.engine import PackageQueryEngine
    from repro_torch.core.lp import solve_lp
    eng = PackageQueryEngine(table, attrs, mesh=m, device="cpu",
                             **kw).partition()
    out = {"layers": _layers(eng.hierarchy)}
    if query is not None:
        r = eng.solve(query, lp_solver=functools.partial(
            solve_lp, mesh=m, device="cpu"))
        out.update(feasible=r.feasible, idx=r.idx, mult=r.mult, obj=r.obj,
                   report=r.report.status)
    return out


def case_hierarchy(m, table, attrs, **kw):
    from repro_torch.core.hierarchy import Hierarchy
    return {"layers": _layers(Hierarchy(table, attrs, mesh=m, device="cpu",
                                        rng=np.random.default_rng(0),
                                        **kw))}


def _full(t):
    """A DTensor gathered whole (every rank calls it), as numpy."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().numpy()


def layout_run(m, cfg, params, batch, decode_steps=2, cache_len=32,
               train=False, rules=True, flags=None):
    """The port's model of ``cfg`` on ``params`` (numpy tree) with the
    sharding rules of mesh ``m`` active (``rules``; ``flags`` their
    perf flags, ``ShardingRules`` fields) or none: the prefill logits and
    ``decode_steps`` decode steps' logits and cache, or with ``train``
    the loss and every parameter's gradient; all gathered to numpy."""
    import torch
    from repro_torch.distributed.context import use_rules
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.models.convert import from_jax_params
    from repro_torch.models.param import leaves
    model = from_jax_params(params, cfg, device="cpu")
    r = None
    if rules:
        r = make_rules(m, **(flags or {}))
        r.shard_params(model)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    with use_rules(r):
        if train:
            model.requires_grad_(True)
            loss, _ = model.loss_fn(b)
            flat = [q for _, q in leaves(model.params)]
            grads = torch.autograd.grad(loss, flat)
            return {"loss": _full(loss),
                    "grads": {n: _full(g) for (n, _), g in
                              zip(leaves(model.params), grads)}}
        out = {"prefill": _full(model.prefill_logits(b))}
        enc = b["enc_inputs"].shape[1] if "enc_inputs" in b else None
        cache = model.init_cache(b["tokens"].shape[0], cache_len,
                                 enc_len=enc)
        for t in range(decode_steps):
            logits, cache = model.decode_step(cache, b["tokens"][:, t:t + 1])
            out[f"decode{t}"] = _full(logits)
        out["cache"] = {k: _full(v) for k, v in cache.items()
                        if k != "index"}
    return out


def case_layout(m, arch, params, batch, cfg_kw=None, **kw):
    """:func:`layout_run` of the float32 smoke config of ``arch``
    (``cfg_kw`` replaced in it)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch + "-smoke"),
                              param_dtype="float32", **(cfg_kw or {}))
    return layout_run(m, cfg, params, batch, **kw)


CASES = {"layout": case_layout, "step": case_step, "update": case_update,
         "refresh": case_refresh,
         "solve": case_solve, "shard_fault": case_shard_fault,
         "group_stats": case_group_stats,
         "streaming_stats": case_streaming_stats,
         "dlv_bucketed": case_dlv_bucketed, "fit": case_fit,
         "engine": case_engine, "hierarchy": case_hierarchy}
