"""The port's dry-run (``repro_torch.launch.dryrun``) on the production
16 x 16 mesh over a fake process group of 256 ranks, in a subprocess
(the group is process-wide).

Smoke configs at the reference's cell shapes: each cell ``OK``, its
``argument_size_in_bytes`` equal to the local shard bytes that the
reference's specs give (``repro.distributed.sharding`` on an abstract
mesh, the reference's shapes and dtypes), every collective of a known
kind, FLOPs and collectives counted.  Then ``--pq``: ``OK`` with no
update-step collective and the pq step within its byte budget (the
reference's record at n = 2^24: ``budget_used_frac`` 0.249); here at
n = 2^16, the full size runs from the CLI.
"""
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.distributed.sharding import make_rules as ref_make_rules
from repro.launch.mesh import make_abstract_mesh as ref_abstract_mesh
from repro.models import Model as RefModel
from repro_torch.analysis.collectives import FACTORS

CELLS = [("smollm-135m-smoke", "train_4k"),
         ("mixtral-8x22b-smoke", "prefill_32k"),
         ("qwen2-1.5b-smoke", "decode_32k"),
         ("mamba2-1.3b-smoke", "long_500k")]
PQ_N = 1 << 16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = f"""
import json, sys
from repro_torch.launch import dryrun
out = {{}}
for arch, shape in {CELLS!r}:
    out[arch + " " + shape] = dryrun.run_cell(arch, shape, multi_pod=False)
out["pq"] = dryrun.run_pq_cell(multi_pod=False, n={PQ_N})
sys.stdout.write("RESULT " + json.dumps(out) + "\\n")
"""


@pytest.fixture(scope="module")
def records():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    line = next(ln for ln in p.stdout.splitlines()
                if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def _local_bytes(shape, dtype, spec, sizes) -> int:
    n = math.prod(shape) * np.dtype(dtype).itemsize
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                n //= sizes[a]
    return n


def _ref_arg_bytes(arch, shape_name) -> int:
    """The cell's inputs' local bytes by the reference's specs: the
    parameters (and for a train cell the AdamW moments and step), the
    batch over dp, a decode cell's caches and token."""
    rules = ref_make_rules(ref_abstract_mesh((16, 16), ("data", "model")))
    sizes = dict(rules.mesh.shape)
    cfg = ref_config(arch)
    shape = REF_SHAPES[shape_name]
    model = RefModel(cfg)
    flat = jax.tree.leaves(model.abstract_params())
    axes = jax.tree.leaves(model.axes(), is_leaf=lambda x: isinstance(
        x, tuple) and all(isinstance(e, (str, type(None))) for e in x))
    total = 0
    for leaf, ax in zip(flat, axes):
        spec = tuple(rules.param_pspec(leaf.shape, ax))
        total += _local_bytes(leaf.shape, leaf.dtype, spec, sizes)
        if shape.kind == "train":
            total += 2 * _local_bytes(leaf.shape, cfg.opt_dtype, spec, sizes)
    B = shape.global_batch
    dp = rules._dp_entry(B)
    if shape.kind == "train":
        total += 4                                  # the step count
    if shape.kind in ("train", "prefill"):
        s = shape.seq_len - cfg.num_prefix_tokens
        for _ in range(2 if shape.kind == "train" else 1):
            total += _local_bytes((B, s), np.int32, (dp, None), sizes)
        return total
    cache = model.init_cache(B, shape.seq_len, abstract=True)
    from repro.launch.specs import cache_shardings
    for key, spec in cache_shardings(cache, rules).items():
        if key != "index":
            total += _local_bytes(cache[key].shape, cache[key].dtype,
                                  tuple(spec.spec), sizes)
    return total + _local_bytes((B, 1), np.int32, (dp, None), sizes)


@pytest.mark.parametrize("arch, shape", CELLS)
def test_smoke_cell_is_ok_with_the_reference_argument_bytes(records, arch,
                                                            shape):
    rec = records[f"{arch} {shape}"]
    assert rec["status"] == "OK", rec
    assert rec["n_devices"] == 256 and rec["mesh"] == "16x16"
    assert rec["memory"]["argument_size_in_bytes"] == \
        _ref_arg_bytes(arch, shape)
    assert rec["memory"]["output_size_in_bytes"] > 0
    assert rec["memory"]["peak_memory_in_bytes"] >= \
        rec["memory"]["argument_size_in_bytes"]
    assert rec["dot_flops"] > 0 and rec["cost"]["flops"] == rec["dot_flops"]


@pytest.mark.parametrize("arch, shape", CELLS)
def test_every_collective_has_a_known_kind(records, arch, shape):
    rec = records[f"{arch} {shape}"]
    kinds = set(rec["collective_counts"])
    assert kinds and kinds <= set(FACTORS), kinds
    assert set(rec["collectives"]) == kinds | {"total"}
    assert rec["collectives"]["total"] == pytest.approx(
        sum(v for k, v in rec["collectives"].items() if k != "total"))


def test_train_cell_reduces_its_gradients(records):
    rec = records["smollm-135m-smoke train_4k"]
    # FSDP: parameters gathered, gradients reduce-scattered
    assert rec["collective_counts"].get("all-gather", 0) > 0
    assert rec["collective_counts"].get("reduce-scatter", 0) > 0


def test_pq_step_is_ok_within_its_budget(records):
    rec = records["pq"]
    assert rec["status"] == "OK", rec.get("violations")
    assert rec["n_devices"] == 256
    assert rec["update_collectives"] == 0
    assert 0 < rec["budget_used_frac"] <= 1.0
    assert set(rec["collective_counts"]) <= set(FACTORS)
