"""Ambient sharding-rules context for activation placements (port of
``repro.distributed.context``).

Model code calls ``constrain(x, ("dp", None, "tp"))`` at the reference's
sites.  With no ``ShardingRules`` active (``use_rules``) each call
returns its input, the same object, so a run without rules is the
single-device model bit for bit.  Under rules the call pins ``x``'s
placement on the rules' ``DeviceMesh``: a DTensor is redistributed to the
spec's placements; a plain tensor is one the model built alike on every
rank (the attention scan's carries, the SSM's initial state, the
embeddings of replicated inputs), so it enters as a replicated DTensor
(``DTensor.from_local``) and is then redistributed (Replicate -> Shard is
a local slice and moves no bytes).  Anything else raises, naming the
call site.

Entry vocabulary per dim:
  None      leave unsharded
  "dp"      data-parallel axes (pod, data) if the dim divides
  "tp"      model axis if the dim divides
  "dp+tp"   both (e.g. very long sequence dims)
"""
from __future__ import annotations

import contextlib
import sys
import threading
from typing import Optional, Sequence

import torch

from repro_torch.distributed.sharding import P, ShardingRules

_STATE = threading.local()


def current_rules() -> Optional[ShardingRules]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    """``rules`` active on this thread.  Active rules also let DTensor
    ops take the plain tensors the model builds alike on every rank as
    replicated (DTensor's implicit replication, as
    ``torch.distributed.tensor.experimental.implicit_replication`` sets
    it; restored on exit)."""
    prev = current_rules()
    _STATE.rules = rules
    dispatcher = prev_implicit = None
    if rules is not None:
        from torch.distributed.tensor import DTensor
        dispatcher = DTensor._op_dispatcher
        prev_implicit = dispatcher._allow_implicit_replication
        dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        _STATE.rules = prev
        if dispatcher is not None:
            dispatcher._allow_implicit_replication = prev_implicit


@contextlib.contextmanager
def _entered(*cms):
    with contextlib.ExitStack() as stack:
        for cm in cms:
            stack.enter_context(cm)
        yield


def checkpoint_context_fn(inner=None):
    """A ``context_fn`` for ``torch.utils.checkpoint`` (or None when no
    rules are active and no ``inner`` is given): the recomputation runs
    under the rules that were active in the forward.  The rules (and
    DTensor's implicit replication) are a thread's, and on a card
    autograd recomputes on its own thread.
    ``inner`` is another ``context_fn`` (selective checkpointing's), whose
    two contexts are kept."""
    rules = current_rules()
    if rules is None:
        return inner

    def fn():
        fwd, rec = inner() if inner is not None else (
            contextlib.nullcontext(), contextlib.nullcontext())
        return fwd, _entered(rec, use_rules(rules))
    return fn


def _entry(rules: ShardingRules, dim: int, tag):
    if tag is None:
        return None
    if tag == "dp":
        return rules._dp_entry(dim)
    if tag == "tp":
        tp = rules.tp_size
        return rules.tp_axis if dim % tp == 0 and dim >= tp else None
    if tag == "dp+tp":
        total = rules.dp_size * rules.tp_size
        if dim % total == 0 and dim >= total:
            return tuple(rules.dp_axes) + (rules.tp_axis,)
        return _entry(rules, dim, "tp")
    raise ValueError(tag)


def _caller() -> str:
    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    return "<unknown>" if f is None else \
        f"{f.f_code.co_filename}:{f.f_lineno}"


def _place(rules: ShardingRules, x, pspec: P):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"constrain at {_caller()}: a {type(x).__name__} "
                        "is not a tensor")
    if not hasattr(rules.mesh, "device_type"):
        raise TypeError(f"constrain at {_caller()}: the rules' mesh is "
                        "abstract (names and sizes only); placing a tensor "
                        "needs a DeviceMesh")
    try:
        return rules.place(x, pspec)
    except (ValueError, RuntimeError, NotImplementedError) as e:
        raise type(e)(f"constrain at {_caller()}: {pspec} on "
                      f"{tuple(x.shape)}: {e}") from e


def spec_of(x: torch.Tensor, spec: Sequence) -> P:
    """The placement spec that ``constrain(x, spec)`` pins under the
    active rules (``spec``'s tags resolved against ``x``'s dims)."""
    rules = current_rules()
    if len(spec) != x.dim():
        raise ValueError(f"constrain at {_caller()}: spec {tuple(spec)} "
                         f"for a tensor of shape {tuple(x.shape)}")
    return P(*[_entry(rules, d, t) for d, t in zip(x.shape, spec)])


def constrain(x: torch.Tensor, spec: Sequence) -> torch.Tensor:
    rules = current_rules()
    if rules is None:
        return x
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"constrain at {_caller()}: a {type(x).__name__} "
                        "is not a tensor")
    return _place(rules, x, spec_of(x, spec))


def constrain_decode_act(x: torch.Tensor) -> torch.Tensor:
    """Per-token decode activations: batch over dp normally; under
    ``replicate_decode_activations`` the embedding dim is sharded over
    dp instead, aligned with the weights' FSDP (contraction) dim."""
    rules = current_rules()
    if rules is None:
        return x
    if rules.replicate_decode_activations:
        return constrain(x, (None,) * (x.dim() - 1) + ("dp",))
    return constrain(x, ("dp",) + (None,) * (x.dim() - 1))


def constrain_cache(x: torch.Tensor, kind: str) -> torch.Tensor:
    """One layer's decode cache on ``ShardingRules.cache_pspec``'s
    placement (layer dim stripped): kv/mla -> B over dp, S over model
    (+dp when B does not divide); state/conv -> B over dp,
    heads/channels over model."""
    rules = current_rules()
    if rules is None:
        return x
    pspec = rules.cache_pspec((1,) + tuple(x.shape), kind)
    return _place(rules, x, P(*pspec[1:]))
