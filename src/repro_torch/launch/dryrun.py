"""Multi-pod dry-run of the port: every (arch x shape x mesh) cell's step
traced on the production meshes (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell with XLA over 512 host
devices.  The port has no compiler to ask, so a cell runs as rank 0 of a
``"fake"`` process group of 256 (16 x 16) or 512 (2 x 16 x 16) ranks,
under ``FakeTensorMode``: every tensor is a DTensor whose local shard is
fake (shapes and dtypes, no memory), every collective returns at once,
and the step is the port's own code under its sharding rules
(``launch.specs.build_cell``).  One process, no card.  What a record
holds (the reference's JSON keys where the meaning is the same):

  memory.argument_size_in_bytes / output_size_in_bytes
      the step's inputs' / outputs' local shard bytes on rank 0, exact;
  memory.peak_memory_in_bytes
      ``MemTracker``'s peak of the eager step on rank 0 (arguments
      included): an eager peak, not XLA's buffer-assigned one;
  cost.flops, dot_flops
      ``FlopCounterMode``'s registry over the local products rank 0 runs
      (forward, backward and recomputation; the products only, so the two
      are equal);
  collectives, collective_counts
      per-device ring bytes and counts by kind of the functional
      collectives that DTensor's redistributions issue
      (``analysis.contracts.OpTrace``, ``analysis.collectives``);
  wall_s
      the CPU seconds of the traced step (not a card time).

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --all [--both-meshes] [--out DIR]
  python -m repro_torch.launch.dryrun --pq [--both-meshes]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, \
    shape_applicable

WORLD = {False: 256, True: 512}


@contextlib.contextmanager
def fake_world(multi_pod: bool):
    """A ``"fake"`` process group of 256 or 512 ranks, this process rank
    0, torn down on exit (the group is process-wide)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is up already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD[bool(multi_pod)])
    try:
        yield
    finally:
        dist.destroy_process_group()


class LocalFlops:
    """The product FLOPs of the local ops run inside (DTensor ops are
    left to DTensor, whose local ops come back through here)."""

    def __init__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        outer = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                f = flop_registry.get(getattr(func, "_overloadpacket",
                                              None))
                if f is not None:
                    outer.flops += int(f(*args, **kwargs, out_val=out))
                return out

        self.flops = 0
        self.mode = _Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)


def _local_tensors(tree):
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _local_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _local_tensors(v)
    elif isinstance(tree, DTensor):
        yield tree._local_tensor
    elif isinstance(tree, torch.Tensor):
        yield tree


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _local_tensors(tree))


def _cell_args(cell):
    """What the step reads: the model's parameters (and a train cell's
    moments and step) and the cell's arguments."""
    if "params" in (cell.args[0] if isinstance(cell.args[0], dict) else {}):
        return cell.args
    return (cell.model.params,) + tuple(cell.args)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool) -> dict:
    from repro_torch.launch.mesh import make_production_mesh
    cfg = get_config(arch)
    ok, why = shape_applicable(cfg, SHAPES[shape_name])
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if not ok:
        rec.update(status="SKIP", reason=why)
        return rec
    t0 = time.time()
    with fake_world(multi_pod):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        rec.update(_traced(arch, shape_name, mesh, t0))
    return rec


def _traced(arch, shape_name, mesh, t0) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.analysis.contracts import OpTrace
    from repro_torch.launch.specs import build_cell
    with FakeTensorMode():
        cell = build_cell(arch, shape_name, mesh)
        t_build = time.time() - t0
        args = _cell_args(cell)
        arg_bytes = _nbytes(args)
        mt = MemTracker()
        mt.track_external(*_local_tensors(args))
        flops = LocalFlops()
        t1 = time.time()
        with mt, OpTrace("cpu") as tr, flops:
            out = cell.fn(*cell.args)
        t_run = time.time() - t1
        if cell.shape.startswith("train"):
            out = (cell.args[0], out)          # the state, updated in place
        out_bytes = _nbytes(out)
        peak = sum(v for d in mt.get_tracker_snapshot("peak").values()
                   for k, v in d.items() if k == "Total")
        st = tr.collective_stats()
        n_dev = mesh.size()
    return dict(
        status="OK",
        build_s=round(t_build, 1),
        wall_s=round(t_run, 1),
        n_devices=int(n_dev),
        memory={"argument_size_in_bytes": int(arg_bytes),
                "output_size_in_bytes": int(out_bytes),
                "peak_memory_in_bytes": int(peak),
                "peak_kind": "eager (MemTracker), not XLA's"},
        cost={"flops": float(flops.flops)},
        collectives={k: float(v) for k, v in st.merged().items()},
        collective_counts=dict(st.count_by_kind),
        dot_flops=float(flops.flops),
        rules={"replicate_decode_activations": bool(
            cell.rules.replicate_decode_activations),
            "seq_parallel_attn": bool(cell.rules.seq_parallel_attn)},
    )


def run_pq_cell(*, multi_pod: bool, n: int = 1 << 24) -> dict:
    """The paper's own technique on the full mesh: one distributed
    dual-simplex pivot (the pricing + exact-BFRT selection step) and the
    post-pivot O(n/p) update step, through the contract checker
    (``analysis.contracts.check_pq_step`` / ``check_update_step``) on
    rank 0 of the fake group, so the dry-run and the analysis prove the
    same invariants (zero update collectives, the pq byte budget, dense
    passes, float32 kept)."""
    from repro_torch.analysis import contracts
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": "pq_step", "shape": f"m8_n{n}", "mesh": mesh_name}
    with fake_world(multi_pod):
        ctx = contracts.pod_ctx(multi_pod)
        pq = contracts.check_pq_step(ctx, 8, n)
        upd = contracts.check_update_step(ctx, 8, n)
    viols = pq.violations + upd.violations
    rec.update(
        status="OK" if not viols else "CONTRACT_FAIL",
        wall_s=round(pq.wall_s + upd.wall_s, 1),
        n_devices=int(ctx.p),
        collectives=pq.record["collective_bytes"],
        collective_counts=pq.record["collective_counts"],
        budget_bytes=pq.record["budget_bytes"],
        budget_used_frac=pq.record["budget_used_frac"],
        dense_passes=pq.record["dense_passes"],
        update_collectives=upd.record["collectives"],
        violations=[v.format() for v in viols],
    )
    return rec


_ERRORS = (ValueError, TypeError, KeyError, RuntimeError,
           NotImplementedError, OSError, AssertionError)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="trace every (arch x shape x mesh) cell of the port "
                    "on the production meshes over a fake process group "
                    "(CPU analysis: local shard bytes, FLOPs and "
                    "collective bytes, not card timings); the reference's "
                    "--save-hlo has no counterpart: the port lowers to no "
                    "HLO")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--pq", action="store_true",
                    help="dry-run the distributed package-query step")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    if args.pq:
        rc = 0
        for mp in meshes:
            mesh_name = "2x16x16" if mp else "16x16"
            try:
                rec = run_pq_cell(multi_pod=mp)
            except _ERRORS as e:
                rec = {"arch": "pq_step", "mesh": mesh_name, "status": "FAIL",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
            if rec["status"] != "OK":
                rc = 1
            with open(os.path.join(args.out,
                                   f"pq_step__{mesh_name}.json"), "w") as f:
                json.dump(rec, f, indent=1)
            print(f"[dryrun] pq_step {mesh_name}: {rec['status']} "
                  + rec.get("error", "")[:200], flush=True)
            for v in rec.get("violations", ()):
                print(f"  {v}", flush=True)
            if rec["status"] in ("OK", "CONTRACT_FAIL"):
                total = rec["collectives"].get("total", 0)
                print(f"  coll_bytes/dev={total:.3e} "
                      f"budget_used={rec['budget_used_frac']:.3f} "
                      f"update_collectives={rec['update_collectives']} "
                      f"wall={rec['wall_s']}s", flush=True)
        return rc

    if not (args.all or args.arch or args.shape):
        ap.error("give --all, --arch/--shape or --pq")
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    failures = 0
    t_all = time.time()
    for mp in meshes:
        mesh_name = "2x16x16" if mp else "16x16"
        for a in archs:
            for s in shapes:
                path = os.path.join(args.out, f"{a}__{s}__{mesh_name}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[dryrun] {a} {s} {mesh_name}: exists, skipping")
                    continue
                print(f"[dryrun] {a} {s} {mesh_name} ...", flush=True)
                try:
                    rec = run_cell(a, s, multi_pod=mp)
                except _ERRORS as e:
                    rec = {"arch": a, "shape": s, "mesh": mesh_name,
                           "status": "FAIL",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    failures += 1
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                msg = rec["status"]
                if rec["status"] == "OK":
                    msg += (f" wall={rec['wall_s']}s"
                            f" arg_bytes/dev="
                            f"{rec['memory']['argument_size_in_bytes'] / 2**30:.2f}GiB"
                            f" dot_flops/dev={rec['dot_flops']:.3e}"
                            f" coll_bytes/dev="
                            f"{rec['collectives'].get('total', 0):.3e}")
                elif rec["status"] == "FAIL":
                    msg += " " + rec["error"][:200]
                else:
                    msg += " " + rec.get("reason", "")
                print(f"[dryrun] {a} {s} {mesh_name}: {msg}", flush=True)
    print(f"[dryrun] done, {failures} failures, "
          f"{time.time() - t_all:.1f}s", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
