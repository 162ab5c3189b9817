"""Per-cell (arch x shape x mesh) steps, inputs and placements (port of
``repro.launch.specs``).

``build_cell`` gives a cell's step and its arguments as DTensors on their
placements: the parameters on ``ShardingRules.param_pspec`` (and, for a
train cell, the AdamW moments on the same), the batch B over the
data-parallel axes, a decode cell's caches on ``cache_pspec``.  Each
argument is made from its local shard alone (``DTensor.from_local``), so
under ``FakeTensorMode`` (the dry-run's) nothing is allocated and a
rank's memory is its shards'.  Outside fake mode the inputs are zeros.
The step runs the port's entry points (``Model.loss_fn`` through
``training.step.make_train_step``, ``Model.prefill_logits``,
``Model.decode_step``) with the rules active and places its outputs on
the cell's output specs, as the reference's ``out_shardings`` do.

The reference's two environment switches (contraction-aligned decode
activations, on by default; sequence-parallel attention, off) are the
keyword arguments ``replicate_decode`` and ``seq_parallel_attn``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs import SHAPES, ArchConfig, ShapeConfig, get_config
from repro_torch.distributed.context import use_rules
from repro_torch.distributed.sharding import (P, ShardingRules, cache_kind,
                                              local_extent, make_rules)
from repro_torch.models.model import Model
from repro_torch.models.param import leaves


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    fn: Callable
    args: Tuple[Any, ...]
    in_specs: Tuple[Any, ...]
    out_specs: Any
    rules: ShardingRules
    model: Model


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, *, with_labels: bool):
    """Train/prefill inputs as {name: (shape, dtype)} and their specs,
    "__dp__" standing for the batch dim's dp entry."""
    B, S = shape.global_batch, shape.seq_len
    s_tokens = S - cfg.num_prefix_tokens if cfg.num_prefix_tokens else S
    batch = {"tokens": ((B, s_tokens), torch.int32)}
    specs = {"tokens": P("__dp__", None)}
    if with_labels:
        batch["labels"] = ((B, s_tokens), torch.int32)
        specs["labels"] = P("__dp__", None)
    if cfg.is_encoder_decoder:
        batch["enc_inputs"] = ((B, cfg.encoder_seq_len, cfg.d_model),
                               torch.bfloat16)
        specs["enc_inputs"] = P("__dp__", None, None)
    if cfg.num_prefix_tokens:
        batch["prefix"] = ((B, cfg.num_prefix_tokens, cfg.d_model),
                           torch.bfloat16)
        specs["prefix"] = P("__dp__", None, None)
    return batch, specs


def _resolve_dp(pspec: P, rules: ShardingRules, batch_size: int) -> P:
    """``pspec`` with its "__dp__" placeholder replaced by the dp entry."""
    entry = rules._dp_entry(batch_size)
    return P(*[entry if e == "__dp__" else e for e in pspec])


def cache_shapes(model: Model, batch_size: int, cache_len: int
                 ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{key: (shape, dtype)} of ``model.init_cache``'s tensors, from the
    shapes alone (nothing allocated)."""
    dev = model.device
    model.device = torch.device("meta")
    try:
        cache = model.init_cache(batch_size, cache_len)
    finally:
        model.device = dev
    return {k: (tuple(v.shape), v.dtype) for k, v in cache.items()
            if k != "index"}


def cache_shardings(cache: Dict[str, Any], rules: ShardingRules
                    ) -> Dict[str, P]:
    """{key: spec} of a cache ({key: (shape, dtype)} or tensors); the
    host int index has none."""
    out = {}
    for key, v in cache.items():
        kind = cache_kind(key)
        if kind is None:
            continue
        shape = v[0] if isinstance(v, tuple) else tuple(v.shape)
        out[key] = rules.cache_pspec(shape, kind)
    return out


def local_dtensor(shape, dtype, rules: ShardingRules, pspec: P):
    """A DTensor of global ``shape`` on ``pspec``'s placements made from
    its local shard alone: zeros (fake under ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor
    pl = rules.placements(pspec)
    local_shape, _ = local_extent(shape, rules.mesh, pl)
    dev = rules.mesh.device_type
    local = torch.zeros(local_shape, dtype=dtype, device=dev)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, rules.mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def sharded_model(cfg: ArchConfig, rules: ShardingRules) -> Model:
    """``Model(cfg)`` on the rules' mesh with every parameter a DTensor
    on its ``param_pspec``, made from its local shard."""
    model = Model(cfg, device=rules.mesh.device_type)
    tree: Dict[str, Any] = {}
    for name, info in leaves(model.spec()):
        node = tree
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = local_dtensor(info.shape, model.dtype, rules,
                                   rules.param_pspec(info.shape, info.axes))
    return model.load_params(tree)


def _placed(rules: ShardingRules, tree, specs):
    """``tree``'s tensors on ``specs``'s placements (same structure,
    tuples and dicts; a None spec: replicated)."""
    if isinstance(tree, tuple):
        return tuple(_placed(rules, v, specs[i] if isinstance(specs, tuple)
                             else specs) for i, v in enumerate(tree))
    if isinstance(tree, dict):
        return {k: _placed(rules, v, specs.get(k) if isinstance(specs, dict)
                           else specs) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    spec = specs if specs is not None else P(*([None] * tree.dim()))
    return rules.place(tree, spec)


def _with_rules(fn, rules: ShardingRules, out_specs):
    """``fn`` run with ``rules`` active, its outputs placed on
    ``out_specs``."""
    import functools

    @functools.wraps(fn)
    def wrapped(*args):
        with use_rules(rules):
            return _placed(rules, fn(*args), out_specs)
    return wrapped


def build_cell(arch: str, shape_name: str, mesh, *,
               replicate_decode: bool = True,
               seq_parallel_attn: bool = False) -> Cell:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rules = make_rules(mesh, seq_parallel_attn=seq_parallel_attn)
    if shape.kind == "decode" and replicate_decode:
        rules = dataclasses.replace(rules, replicate_decode_activations=True)
    model = sharded_model(cfg, rules)
    B = shape.global_batch
    V = cfg.padded_vocab
    vocab = rules.tp_axis if V % rules.tp_size == 0 else None
    p_specs = {name: rules.param_pspec(info.shape, info.axes)
               for name, info in leaves(model.spec())}

    def batch_args(with_labels: bool):
        batch, bspecs = batch_specs(cfg, shape, with_labels=with_labels)
        specs = {k: _resolve_dp(v, rules, B) for k, v in bspecs.items()}
        args = {k: local_dtensor(s, dt, rules, specs[k])
                for k, (s, dt) in batch.items()}
        return args, specs

    if shape.kind == "train":
        from repro_torch.training.step import (init_train_state,
                                               make_train_step)
        state = init_train_state(model)
        batch, bspecs = batch_args(True)
        step = make_train_step(model)
        state_specs = {"params": None, "opt": {"step": P()}}
        fn = _with_rules(lambda st, b: step(st, b)[1], rules, None)
        return Cell(arch, shape_name, fn, (state, batch),
                    ({"params": p_specs, "opt": {"mu": p_specs,
                                                 "nu": p_specs,
                                                 "step": P()}}, bspecs),
                    (state_specs, None), rules, model)

    if shape.kind == "prefill":
        batch, bspecs = batch_args(False)
        out_spec = P(rules._dp_entry(B), None, vocab)
        fn = _with_rules(lambda b: model.prefill_logits(b), rules, out_spec)
        return Cell(arch, shape_name, fn, (batch,), (p_specs, bspecs),
                    out_spec, rules, model)

    # decode: one new token against a cache of shape.seq_len
    shapes = cache_shapes(model, B, shape.seq_len)
    c_specs = cache_shardings(shapes, rules)
    cache = {k: local_dtensor(s, dt, rules, c_specs[k])
             for k, (s, dt) in shapes.items()}
    cache["index"] = 0
    t_spec = P(rules._dp_entry(B), None)
    tokens = local_dtensor((B, 1), torch.int32, rules, t_spec)
    logits_spec = P(rules._dp_entry(B), vocab)
    fn = _with_rules(lambda c, t: model.decode_step(c, t), rules,
                     (logits_spec, c_specs))
    return Cell(arch, shape_name, fn, (cache, tokens),
                (p_specs, c_specs, t_spec), (logits_spec, c_specs), rules,
                model)
