"""Traced contracts on the port's hot paths (counterpart of
``repro.analysis.contracts``).

The reference lowers each hot path to a jaxpr and to HLO and proves its
invariants on the IR.  Torch lowers to neither, so the port runs each hot
path once, at a small size, under :class:`OpTrace` -- a
``TorchDispatchMode`` (every c10d collective, every aten op that syncs
with the host by itself -- ``nonzero``, ``_local_scalar_dense``, a
boolean-mask index and the like -- and the ops that make float64 from no
float64 input) together with a
``TorchFunctionMode`` (``.cpu()``, ``.item()``, ``.tolist()``,
``.numpy()``, ``float()``/``int()``/``bool()`` of a tensor: on CPU tensors
``.cpu()`` is a no-op the dispatcher never sees) -- and holds what ran to
the port's declared counts.  The pivot loops mark each pivot
(``runtime.tracepoints.pivot``); every host read, collective and dense
pass is attributed to the pivot it ran in and to the file:line that made
it.

The contracts (ids ``IRC00x``, as the reference's):

``IRC001`` zero collectives: the post-pivot update step and the batched
    LP engine run no c10d op at all.
``IRC002`` dense-pass discipline: the pq step reads ``A_loc`` in exactly
    its declared passes a pivot (:data:`DECLARED_PASSES`: the pricing
    sweep and the flip absorption ``A @ dx``; the reference has one sweep
    and a second inside a ``cond``), the update step in none, the refresh
    step -- the only recompute site -- in one or two.  On a card the
    pricing pass is a ``csrc/pricing.cu`` launch, read from the wrapper's
    launch counter (the profiler loses launches); the device LP must
    launch pricing once a pivot, so a plain version cannot stand in.
``IRC003`` no host read inside a pivot loop but the declared ones
    (:data:`DECLARED_READS`), each at most once a pivot; on a card the
    device LP makes one BFRT select call a pivot (the kernel's counter).
``IRC004`` collective budget: the pq step's per-pivot collective bytes
    (the ring model of :mod:`repro_torch.analysis.collectives` over the
    traced c10d records) within :func:`collectives.pq_collective_budget`.
``IRC005`` dtype preservation: a hot path run on float32 inputs
    introduces float64 only at the declared sites (:data:`DECLARED_F64`).

Every finding is a :class:`Violation` whose ``path`` is
``<hot path>@<world>`` and whose message starts with the file:line that
made it.  ``run_contracts(grid)`` runs the grid: ``"host"`` on the CPU
(a world of one rank in process and a gloo world of two spawned over
loopback), ``"card"`` on CUDA (a world of one rank on NCCL; raises
without a card).  The reference's ``"pod"`` grid needs the production
mesh (``launch/mesh.py``), which the port does not have yet.
"""
from __future__ import annotations

import ast
import contextlib
import dataclasses
import datetime
import functools
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import collectives, lint
from repro_torch.analysis.collectives import (CollectiveRecord,
                                              pq_collective_budget)
from repro_torch.analysis.report import Violation
from repro_torch.runtime import tracepoints

CONTRACTS: Dict[str, str] = {
    "IRC001": "zero collectives in the post-pivot update step and the "
              "batched LP engine",
    "IRC002": "dense-pass discipline (the pq step's declared passes over "
              "A_loc, none in the update, refresh the only recompute "
              "site; pricing launched once a pivot on a card)",
    "IRC003": "no host read inside a pivot loop but the declared ones, "
              "each at most once a pivot",
    "IRC004": "per-pivot collective bytes within the declared budget",
    "IRC005": "dtype preservation (f32 inputs introduce f64 only at the "
              "declared sites)",
}

PKG = Path(__file__).resolve().parents[1]          # src/repro_torch
ROOT = PKG.parents[1]                              # the checkout
_TORCH_DIR = str(Path(torch.__file__).resolve().parent)
_STDLIB_DIR = os.path.dirname(os.__file__)
_SKIP_FILES = (str(Path(__file__).resolve()),
               str((PKG / "runtime" / "tracepoints.py").resolve()))

# The declared host reads of the pivot loops: (file, function, the text
# of the read, when it may run, why).  Each may run at most once a pivot;
# "pivot" reads run in every pivot that reaches them.
DECLARED_READS: Tuple[Tuple[str, str, str, str, str], ...] = (
    ("core/lp_kernel.py", "_solve.<locals>.read", ".cpu().tolist()",
     "pivot", "the device LP's one read a pivot: status, drift and "
     "refresh flags in one copy (the next pivot's gates are decided on "
     "the host)"),
    ("core/distributed.py", "solve_lp_dist", "rep.cpu()", "pivot",
     "the pq step's replicated outputs packed in one tensor: the basis "
     "update is host numpy, replicated on every rank"),
    ("core/distributed.py", "solve_lp_dist.<locals>.refresh", "axn.cpu()",
     "refresh", "the refactorization's A xN for the basic values, once "
     "every refactor_every pivots (and on a drift or suspect gate)"),
    ("core/distributed.py", "_any_rank", "t.cpu()", "budget",
     "the ranks agree on a wall-clock deadline: only with a budget on "
     "more than one rank"),
)

# The declared dense passes over A_loc of the pq step a pivot: (file,
# function, passes, why).  The pricing sweep is the plain version on the
# CPU and a launch (counted by the wrapper) on a card: one of the two runs.
PRICING_LAUNCH = "Pricer.__call__ (csrc/pricing.cu launches)"
DECLARED_PASSES: Tuple[Tuple[str, str, int, str], ...] = (
    ("kernels/pricing.py", "pricing_plain", 1,
     "the pricing sweep (alpha = rho A, ratios, flip costs): the kernel's "
     "plain version on the CPU"),
    ("kernels/pricing.py", PRICING_LAUNCH, 1,
     "the pricing sweep on a card: one csrc/pricing.cu launch"),
    ("core/distributed.py", "BoundPQStep.__call__", 1,
     "flip absorption fvec = A dx, always: the reference gathers at most "
     "K flipped columns inside a cond, but choosing needs the strict-flip "
     "count on the host (a sync a pivot), so the port reads A_loc once "
     "more, as the single-device twin does"),
)
PQ_PASSES = 2          # the pricing sweep (either route) and A dx

# The declared float64 introductions under float32 inputs: (file,
# function, statement prefixes (None: the whole function), why).
DECLARED_F64: Tuple[Tuple[str, str, Optional[Tuple[str, ...]], str],
                    ...] = (
    ("core/distributed.py", "BoundPQStep.__call__",
     ("hedges = ", "hist = bfrt_histogram("),
     "the BFRT histogram (csrc/bfrt.cu) sums flip costs in float64 by "
     "design: its edges, ratios and costs go in as float64 (O(n/p))"),
    ("kernels/bfrt.py", "bfrt_histogram_plain", None,
     "the histogram kernel's plain version: float64 sums by design"),
    ("kernels/bfrt.py", "bfrt_histogram", None,
     "the histogram kernel's float64 partial sums and outputs (O(NB) a "
     "block), by design"),
    ("core/distributed.py", "BoundPQStep.__call__",
     ("blk = torch.cat(", "gat = torch.empty("),
     "the candidate block's wire format (O(p K) words): float64 holds a "
     "column index exactly, float32 only up to 2^24"),
    ("core/distributed.py", "BoundPQStep.__call__",
     ("tail = torch.cat(", "rep = torch.cat("),
     "the replicated outputs packed for the pivot's one host read (O(m) "
     "words): q is a column index, exact in float64 only past 2^24"),
)

# ops whose result is a weak scalar or an alias (never an introduction)
_WEAK_OPS = ("aten.scalar_tensor", "aten.lift_fresh", "aten.lift_fresh_copy",
             "aten.detach", "aten.alias", "aten._local_scalar_dense")
# ops that read part of their first input: the elements read are the
# output's
_INDEX_OPS = ("aten.index", "aten.index_select", "aten.gather", "aten.take",
              "aten.embedding")
# ops that sync with the host on a card by themselves
_SYNC_OPS = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
             "aten.is_nonzero", "aten.equal", "aten._unique",
             "aten._unique2", "aten.unique_dim", "aten.unique_consecutive",
             "aten.repeat_interleave.Tensor")
# indexing ops whose boolean-mask index runs a nonzero inside the op,
# below the dispatch mode (an index_put of one mask with a one-element
# host value runs as a masked_fill instead, with no sync)
_MASK_INDEX_OPS = ("aten.index", "aten.index_put", "aten.index_put_",
                   "aten._index_put_impl_")
_MASK_DTYPES = (torch.bool, torch.uint8)
_OP_META: Dict[object, Tuple[str, str, bool]] = {}   # op -> name, base, view
_READ_FUNCS = ("cpu", "item", "tolist", "numpy", "__float__", "__int__",
               "__bool__", "__index__", "__array__", "__complex__", "to")


# ------------------------------------------------------------ the trace


@dataclasses.dataclass(frozen=True)
class Site:
    """Where an op ran: the innermost frame outside torch, the standard
    library and this tracer (file relative to the checkout)."""
    file: str
    line: int
    func: str

    def __str__(self) -> str:
        return f"{self.file}:{self.line}"

    def is_in(self, suffix: str, func: str) -> bool:
        return lint._path_is(self.file, (suffix,)) and self.func == func


@dataclasses.dataclass
class HostRead:
    kind: str
    site: Site
    hot: Optional[str]        # the registered pivot loop it ran in
    pivot: int


def _rel(path: str) -> str:
    try:
        return str(Path(path).resolve().relative_to(ROOT))
    except ValueError:
        return path


@functools.lru_cache(maxsize=None)
def _abs(path: str) -> str:
    return str(Path(path).resolve())


@functools.lru_cache(maxsize=None)
def _site_file(path: str) -> Optional[str]:
    """A code file as a site's file (relative to the checkout), None for
    torch, the standard library, this tracer and generated code."""
    if path.startswith("<"):
        return None
    full = _abs(path)
    if full.startswith((_TORCH_DIR, _STDLIB_DIR)) or full in _SKIP_FILES:
        return None
    return _rel(full)


@functools.lru_cache(maxsize=None)
def _statement(file: str, line: int) -> str:
    """The source of the innermost statement at ``file``:``line`` ('' if
    unreadable)."""
    try:
        src = Path(file).read_text()
    except OSError:
        return ""
    best = None
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.stmt) and \
                node.lineno <= line <= node.end_lineno and \
                not isinstance(node, (ast.FunctionDef, ast.ClassDef,
                                      ast.AsyncFunctionDef, ast.For,
                                      ast.While, ast.If, ast.With, ast.Try)):
            if best is None or node.lineno >= best.lineno:
                best = node
    return (ast.get_source_segment(src, best) or "") if best else ""


@functools.lru_cache(maxsize=None)
def _hot_index() -> Dict[Tuple[str, str], Optional[List[Tuple[int, int]]]]:
    """(absolute file, qualname) of each registered pivot loop -> its
    loops' line ranges (None: the whole function)."""
    out = {}
    for suffix, qual, scope in lint.HOT_LOOPS:
        path = PKG / suffix
        tree = ast.parse(path.read_text())
        regions = lint.hot_regions(tree, qual, scope)
        out[(str(path.resolve()), qual)] = None if scope == "body" else [
            (r.lineno, r.end_lineno) for r in regions]
    return out


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _group_size(args) -> int:
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except (RuntimeError, AttributeError, TypeError):
                continue
    return dist.get_world_size() if dist.is_initialized() else 1


class _Functions(TorchFunctionMode):
    def __init__(self, trace: "OpTrace"):
        super().__init__()
        self.trace = trace

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in _READ_FUNCS and args and \
                isinstance(args[0], torch.Tensor):
            return self.trace._read(name, func, args, kwargs)
        return func(*args, **kwargs)


class _Dispatch(TorchDispatchMode):
    def __init__(self, trace: "OpTrace"):
        super().__init__()
        self.trace = trace

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.trace._op(func, args, kwargs, out)
        return out


class OpTrace:
    """Record what a hot path runs: the count of aten ops, c10d
    collectives (kind, bytes, group), host reads (kind, file:line, the
    pivot loop they ran in) and pivot boundaries; elements read from the
    ``watch`` tensors' storage by each function; on a card, the pricing
    launches, BFRT launches and BFRT select calls at each pivot; with
    ``f64``, the ops that make float64 from no float64 input (run the
    path on float32 inputs to hold it to IRC005).

    ``device`` is the device the path runs on: on a card only reads of
    tensors off the CPU are host reads; on the CPU every tensor stands for
    a device tensor, except those that came out of a read (the trace
    follows them through the ops made of them alone)."""

    def __init__(self, device, watch: Optional[dict] = None,
                 f64: bool = False):
        self.device_type = torch.device(device).type
        self.f64_check = f64
        self.watch = {k: (t.untyped_storage().data_ptr(), t.numel())
                      for k, t in (watch or {}).items()}
        self.n_ops = 0
        self.reads: List[HostRead] = []
        self.collectives: List[Tuple[CollectiveRecord, Site]] = []
        self.f64: List[Tuple[str, Site, int]] = []
        self.elems: Dict[str, Dict[Tuple[str, str], int]] = {
            k: Counter() for k in self.watch}
        self.elem_sites: Dict[Tuple[str, str], Site] = {}
        self.pivot = 0
        self.pivots: Counter = Counter()
        # pricing launches, bfrt launches, bfrt select calls
        self.marks: List[Tuple[int, int, int]] = []
        self._in_read = 0
        self._token = object()
        self._modes = None

    # -------------------------------------------------------- control

    def __enter__(self) -> "OpTrace":
        self._prev = tracepoints.set_listener(self.mark_pivot)
        self._modes = (_Functions(self), _Dispatch(self))
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        for m in reversed(self._modes):
            m.__exit__(*exc)
        tracepoints.set_listener(self._prev)
        self.mark_end()

    def mark_pivot(self, loop: str = "") -> None:
        """The top of a pivot (the loops' trace point calls it)."""
        from repro_torch.kernels import bfrt, pricing
        self.pivot += 1
        self.pivots[loop] += 1
        self.marks.append((pricing.launches, bfrt.launches,
                           bfrt.select_calls))

    def mark_end(self) -> None:
        from repro_torch.kernels import bfrt, pricing
        if len(self.marks) == self.pivot:
            self.marks.append((pricing.launches, bfrt.launches,
                           bfrt.select_calls))

    def launches_per_pivot(self) -> Tuple[List[int], List[int], List[int]]:
        """(pricing launches, bfrt launches, bfrt select calls) in each
        pivot, in order."""
        d = np.diff(np.asarray(self.marks, np.int64).reshape(-1, 3), axis=0)
        return d[:, 0].tolist(), d[:, 1].tolist(), d[:, 2].tolist()

    # ------------------------------------------------------ attribution

    def _site(self) -> Site:
        f = sys._getframe(2)
        while f is not None:
            rel = _site_file(f.f_code.co_filename)
            if rel is not None:
                return Site(rel, f.f_lineno, f.f_code.co_qualname)
            f = f.f_back
        return Site("<unknown>", 0, "")

    @staticmethod
    def _hot() -> Optional[str]:
        idx = _hot_index()
        f = sys._getframe(2)
        while f is not None:
            key = (_abs(f.f_code.co_filename), f.f_code.co_qualname)
            if key in idx:
                ranges = idx[key]
                if ranges is None or any(lo <= f.f_lineno <= hi
                                         for lo, hi in ranges):
                    return key[1]
            f = f.f_back
        return None

    def _is_host(self, t: torch.Tensor) -> bool:
        if self.device_type != "cpu" and t.device.type == "cpu":
            return True
        return getattr(t, "_optrace_host", None) is self._token

    def _mark_host(self, out) -> None:
        for t in _tensors(out):
            t._optrace_host = self._token

    def _mask_sync(self, base: str, args, kwargs) -> bool:
        """Whether an indexing op reads a boolean mask's count on the host
        (its nonzero): a mask index not on the host, unless the op is an
        index_put of that one mask with a one-element value on the CPU
        and no accumulate, which runs as a masked_fill."""
        idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
        masks = [t for t in idx if isinstance(t, torch.Tensor)
                 and t.dtype in _MASK_DTYPES and not self._is_host(t)]
        if not masks:
            return False
        if base == "aten.index":
            return True
        value = args[2] if len(args) > 2 else kwargs.get("values")
        accumulate = args[3] if len(args) > 3 else kwargs.get(
            "accumulate", False)
        return not (len(idx) == 1 and not accumulate
                    and isinstance(value, torch.Tensor)
                    and value.numel() == 1 and value.device.type == "cpu")

    # -------------------------------------------------------- recorders

    def _read(self, name, func, args, kwargs):
        t = args[0]
        kind = name
        if name == "to":
            dev = kwargs.get("device")
            for a in args[1:]:
                if isinstance(a, (str, torch.device)):
                    dev = a
            if dev is None or torch.device(dev).type != "cpu":
                return func(*args, **kwargs)
            kind = "to('cpu')"
        if self._is_host(t):
            return func(*args, **kwargs)
        self.reads.append(HostRead(kind, self._site(), self._hot(),
                                   self.pivot))
        self._in_read += 1
        try:
            out = func(*args, **kwargs)
        finally:
            self._in_read -= 1
        self._mark_host(out)
        return out

    def _op(self, func, args, kwargs, out) -> None:
        meta = _OP_META.get(func)
        if meta is None:
            name = str(func)
            meta = _OP_META[func] = (
                name, name.rsplit(".", 1)[0] if name.count(".") > 1
                else name, bool(getattr(func, "is_view", False)))
        name, base, view = meta
        self.n_ops += 1
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        if name.startswith("c10d."):
            op = name.split(".")[1]
            kind = collectives.C10D_KINDS.get(op)
            if kind is not None:
                nbytes = sum(t.numel() * t.element_size()
                             for t in _tensors(args[:1]))
                self.collectives.append((CollectiveRecord(
                    kind, nbytes, _group_size(args), self.pivot),
                    self._site()))
            return
        if ins and all(self._is_host(t) for t in ins):
            self._mark_host(out)
            return
        if not self._in_read and (base in _SYNC_OPS or name in _SYNC_OPS):
            self.reads.append(HostRead(name, self._site(), self._hot(),
                                       self.pivot))
        if not self._in_read and base in _MASK_INDEX_OPS and \
                self._mask_sync(base, args, kwargs):
            self.reads.append(HostRead(f"{name} (boolean mask)",
                                       self._site(), self._hot(),
                                       self.pivot))
        if not self._in_read and self.device_type != "cpu" and \
                base in ("aten._to_copy", "aten.copy_") and outs and \
                outs[0].device.type == "cpu" and \
                any(t.device.type != "cpu" for t in ins):
            self.reads.append(HostRead(name, self._site(), self._hot(),
                                       self.pivot))
        if self.f64_check and not view and base not in _WEAK_OPS and \
                any(t.dtype == torch.float64 for t in outs) and \
                not any(t.dtype == torch.float64 for t in ins):
            self.f64.append((name, self._site(),
                             sum(t.numel() for t in outs)))
        if self.watch and not view:
            for key, (ptr, _) in self.watch.items():
                n = 0
                for i, t in enumerate(ins):
                    if t.untyped_storage().data_ptr() == ptr:
                        n += outs[0].numel() if (base in _INDEX_OPS
                                                 and outs) else t.numel()
                        if base in _INDEX_OPS:
                            break
                if n:
                    site = self._site()
                    fk = (site.file, site.func)
                    self.elems[key][fk] += n
                    self.elem_sites.setdefault(fk, site)

    # ---------------------------------------------------------- queries

    def passes(self, key: str, per: int) -> Dict[Tuple[str, str], float]:
        """Dense passes over ``watch[key]`` a pivot, by function."""
        numel = self.watch[key][1]
        return {fk: n / numel / max(per, 1)
                for fk, n in self.elems[key].items()}

    def collective_stats(self, per: Optional[int] = None):
        return collectives.collective_stats(
            (r for r, _ in self.collectives), per)


# ------------------------------------------------------------ the checks


@dataclasses.dataclass
class HotPathResult:
    name: str          # e.g. "distributed.pq_step@w2"
    wall_s: float
    record: dict
    violations: List[Violation]

    @property
    def ok(self) -> bool:
        return not self.violations


@dataclasses.dataclass
class Ctx:
    """Where the distributed checks run: this rank of a world of ``p``
    over ``mesh`` on ``device``."""
    mesh: object
    device: torch.device
    p: int
    rank: int

    @property
    def label(self) -> str:
        return f"w{self.p}"


def _declared_read(r: HostRead):
    for suffix, func, text, when, _ in DECLARED_READS:
        if r.site.is_in(suffix, func) and \
                text in _statement(str(ROOT / r.site.file), r.site.line):
            return when
    return None


def _declared_f64(site: Site) -> bool:
    for suffix, func, prefixes, _ in DECLARED_F64:
        if not site.is_in(suffix, func):
            continue
        if prefixes is None:
            return True
        stmt = _statement(str(ROOT / site.file), site.line).lstrip()
        if stmt.startswith(prefixes):
            return True
    return False


def _undeclared_reads(name: str, trace: OpTrace, hot_only: bool
                      ) -> List[Violation]:
    out = []
    for r in trace.reads:
        if hot_only and r.hot is None:
            continue
        if _declared_read(r) is None:
            out.append(Violation(
                "IRC003", name, 0,
                f"{r.site}: host read {r.kind} in {r.hot or r.site.func} "
                f"(pivot {r.pivot}) is not a declared read"))
    return out


def _f64_violations(name: str, trace: OpTrace) -> List[Violation]:
    out, seen = [], set()
    for op, site, numel in trace.f64:
        if _declared_f64(site) or (site, op) in seen:
            continue
        seen.add((site, op))
        out.append(Violation(
            "IRC005", name, 0,
            f"{site}: float32 inputs produce float64 via {op} "
            f"({numel} elements) in {site.func}"))
    return out


def _collective_violations(name: str, trace: OpTrace, what: str
                           ) -> List[Violation]:
    out = []
    for rec, site in trace.collectives:
        out.append(Violation(
            "IRC001", name, 0,
            f"{site}: {rec.kind} of {rec.out_bytes} bytes in {what} -- it "
            "must run no collective"))
    return out


def _pq_inputs(m: int, n: int, seed: int = 0):
    """Host inputs of one pq step: A (m, n), d >= 0, bounds (some
    infinite widths), the state codes, a few rho rows, the budget."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    d = np.abs(rng.normal(size=n))
    lo = np.zeros(n)
    hi = np.where(rng.random(n) < 0.1, np.inf, rng.uniform(0.5, 2.0, n))
    state = rng.choice([0, 1, 2], size=n, p=[0.6, 0.3, 0.1]).astype(np.int32)
    state[np.isinf(hi) & (state == 1)] = 0
    rhos = rng.normal(size=(4, m))
    return A, d, lo, hi, state, rhos


def check_pq_step(ctx: Ctx, m: int = 8, n: int = 1 << 12,
                  num_buckets: int = 128, gather_k: int = 128,
                  pivots: int = 2, bind: Optional[Callable] = None
                  ) -> HotPathResult:
    """The pq step: its declared dense passes a pivot (IRC002), no host
    read (IRC003), collective bytes within the budget (IRC004) -- on
    float64 inputs -- and float64 only at the declared sites on float32
    inputs (IRC005).  ``bind(step, A, l, u)`` makes the bound step
    (default ``step.bind``; tests pass doubles)."""
    from repro_torch.core.distributed import make_pq_step
    from repro_torch.kernels import pricing
    t0 = time.time()
    name = f"distributed.pq_step@{ctx.label}"
    viol: List[Violation] = []
    A, d, lo, hi, state, rhos = _pq_inputs(m, n)
    step, cols, vec = make_pq_step(ctx.mesh, m, n, num_buckets=num_buckets,
                                   gather_k=gather_k)
    bind = bind or (lambda st, A_, l_, u_: st.bind(A_, l_, u_))
    rec = {"hot_path": name, "p": ctx.p, "m": m, "n": n,
           "pivots": pivots}
    for dt in (torch.float64, torch.float32):
        def t(a, dtype=dt):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=ctx.device)
        A_loc = t(A[cols])
        bound = bind(step, A_loc, t(lo[vec]), t(hi[vec]))
        d_loc, st_loc = t(d[vec]), t(state[vec], torch.int32)
        cost = np.abs(A.T @ rhos[0]) * np.where(np.isinf(hi), 1e30, hi)
        budget = float(np.sort(cost)[n // 4])
        launched = pricing.launches
        with OpTrace(ctx.device, watch={"A": A_loc},
                     f64=dt == torch.float32) as tr:
            for i in range(pivots):
                tr.mark_pivot("pq_step")
                bound(d_loc, st_loc, t(rhos[i % len(rhos)]), 1.0, budget)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        if dt == torch.float32:
            viol += _f64_violations(name, tr)
            rec["f64_introductions_f32"] = len(tr.f64)
            continue
        viol += _undeclared_reads(name, tr, hot_only=False)
        passes = tr.passes("A", pivots)
        launch_passes = (pricing.launches - launched) / pivots
        if launch_passes:
            passes[("src/repro_torch/kernels/pricing.py",
                    PRICING_LAUNCH)] = launch_passes
        whole = {fk: int(np.floor(v + 1e-9)) for fk, v in passes.items()}
        declared = {(s, f): k for s, f, k, _ in DECLARED_PASSES}
        for fk, k in whole.items():
            want = next((v for (s, f), v in declared.items()
                         if lint._path_is(fk[0], (s,)) and fk[1] == f), 0)
            if k != want:
                site = tr.elem_sites.get(fk, Site(fk[0], 0, fk[1]))
                viol.append(Violation(
                    "IRC002", name, 0,
                    f"{site}: {k} dense passes over A_loc a pivot in "
                    f"{fk[1]} (declared {want})"))
        total = sum(whole.values())
        if total != PQ_PASSES:
            viol.append(Violation(
                "IRC002", name, 0,
                f"{total} dense passes over A_loc a pivot (declared "
                f"{PQ_PASSES}: the pricing sweep and A dx)"))
        st = tr.collective_stats(per=pivots)
        budget_b = pq_collective_budget(ctx.p, m, num_buckets, gather_k)
        if st.total_bytes > budget_b:
            big = max(tr.collectives, key=lambda rs: rs[0].link_bytes)
            viol.append(Violation(
                "IRC004", name, 0,
                f"{big[1]}: per-pivot collective bytes "
                f"{st.total_bytes:.3e} exceed the declared budget "
                f"{budget_b:.3e} (p={ctx.p}, NB={num_buckets}, "
                f"K={gather_k}); largest {big[0].kind} of "
                f"{big[0].out_bytes} bytes"))
        rec.update(collective_bytes=st.merged(),
                   collective_counts=dict(st.count_by_kind),
                   budget_bytes=float(budget_b),
                   budget_used_frac=float(st.total_bytes / budget_b),
                   dense_passes=round(sum(passes.values()), 6),
                   dense_passes_by_function={
                       f"{f}": round(v, 6) for (_, f), v in passes.items()},
                   pricing_launches_per_pivot=launch_passes,
                   host_reads=len(tr.reads), ops_per_pivot=tr.n_ops / pivots)
    return HotPathResult(name, time.time() - t0, rec, viol)


def check_update_step(ctx: Ctx, m: int = 8, n: int = 1 << 12,
                      step: Optional[Callable] = None) -> HotPathResult:
    """The update step: zero collectives (IRC001), zero dense passes
    (IRC002), no host read (IRC003), float32 kept (IRC005).  ``step``
    overrides the step (a double)."""
    from repro_torch.core.distributed import make_pq_step, make_update_step
    t0 = time.time()
    name = f"distributed.update_step@{ctx.label}"
    viol: List[Violation] = []
    A, d, lo, hi, state, rhos = _pq_inputs(m, n)
    _, cols, vec = make_pq_step(ctx.mesh, m, n)
    upd = step or make_update_step(ctx.mesh)
    rng = np.random.default_rng(1)
    alpha = rng.normal(size=n)
    flips = rng.random(n) < 0.05
    rec = {"hot_path": name, "p": ctx.p, "n": n}
    for dt in (torch.float64, torch.float32):
        def t(a, dtype=dt):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=ctx.device)
        A_loc = t(A[cols])
        args = (t(d[vec]), t(state[vec], torch.int32), t(alpha[vec]),
                t(flips[vec], torch.bool))
        with OpTrace(ctx.device, watch={"A": A_loc},
                     f64=dt == torch.float32) as tr:
            for i in range(2):
                tr.mark_pivot("update_step")
                upd(*args, 0.5, 3 + i, n - 1 - i, bool(i))
        if dt == torch.float32:
            viol += _f64_violations(name, tr)
            continue
        viol += _collective_violations(name, tr, "the post-pivot update")
        viol += _undeclared_reads(name, tr, hot_only=False)
        passes = tr.passes("A", 2)
        for fk, v in passes.items():
            if v >= 1.0 - 1e-9:
                viol.append(Violation(
                    "IRC002", name, 0,
                    f"{tr.elem_sites[fk]}: {v:g} dense passes over A_loc "
                    "in the O(n/p) update step (expected 0)"))
        rec.update(collectives=len(tr.collectives),
                   dense_passes=round(sum(passes.values()), 6),
                   host_reads=len(tr.reads))
    return HotPathResult(name, time.time() - t0, rec, viol)


def check_refresh_step(ctx: Ctx, m: int = 8, n: int = 1 << 12
                       ) -> HotPathResult:
    """The refresh step, the only recompute site: one or two dense
    passes (IRC002), no host read (IRC003), float32 kept (IRC005)."""
    from repro_torch.core.distributed import make_pq_step, make_refresh_step
    t0 = time.time()
    name = f"distributed.refresh_step@{ctx.label}"
    viol: List[Violation] = []
    A, d, lo, hi, state, rhos = _pq_inputs(m, n)
    _, cols, vec = make_pq_step(ctx.mesh, m, n)
    ref = make_refresh_step(ctx.mesh)
    rec = {"hot_path": name, "p": ctx.p, "n": n}
    for dt in (torch.float64, torch.float32):
        def t(a, dtype=dt):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=ctx.device)
        A_loc = t(A[cols])
        with OpTrace(ctx.device, watch={"A": A_loc},
                     f64=dt == torch.float32) as tr:
            tr.mark_pivot("refresh_step")
            ref(A_loc, t(d[vec]), t(state[vec], torch.int32), t(lo[vec]),
                t(hi[vec]), rhos[0])
        if dt == torch.float32:
            viol += _f64_violations(name, tr)
            continue
        viol += _undeclared_reads(name, tr, hot_only=False)
        total = int(np.floor(sum(tr.passes("A", 1).values()) + 1e-9))
        if not 1 <= total <= 2:
            viol.append(Violation(
                "IRC002", name, 0,
                f"{total} dense passes over A_loc in refresh_step "
                "(expected 1 or 2: d = c - y A and the A xN rebuild)"))
        st = tr.collective_stats()
        rec.update(dense_passes=total, collective_bytes=st.merged(),
                   collective_counts=dict(st.count_by_kind),
                   host_reads=len(tr.reads))
    return HotPathResult(name, time.time() - t0, rec, viol)


def _timed(device, fn):
    """(fn(), its wall seconds to the device's last op)."""
    sync = torch.device(device).type == "cuda"
    if sync:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if sync:
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def package_lp(n: int, m: int = 8, seed: int = 0):
    """A paper-style package LP (a count row and m - 1 attribute rows
    around a 30-row package), as ``benchmarks/warm_start.py`` makes
    them: (c, A_t, bl, bu, ub)."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=n)
    A = np.stack([np.ones(n)] + [
        rng.normal(rng.uniform(-5, 15), rng.uniform(1, 3), n)
        for _ in range(m - 1)])
    x0 = np.zeros(n)
    x0[rng.choice(n, min(30, n), replace=False)] = 1.0
    act = A @ x0
    w = np.maximum(np.abs(act) * 0.02, 0.5)
    return c, A, act - w, act + w, np.ones(n)


def _pivot_read_violations(name: str, tr: OpTrace, loop: str
                           ) -> Tuple[List[Violation], Dict[str, List[int]]]:
    """IRC003 for a pivot loop: no undeclared read in it; each declared
    read at most once a pivot, a "pivot" read in every pivot but the
    last.  Returns the violations and each declared read's count in each
    pivot."""
    viol = _undeclared_reads(name, tr, hot_only=True)
    P = tr.pivots[loop]
    per: Dict[str, List[int]] = {}
    for r in tr.reads:
        if r.hot is None:
            continue
        when = _declared_read(r)
        if when is None:
            continue
        key = f"{r.site.func}:{r.kind}"
        per.setdefault(key, [0] * (P + 1))
        if 1 <= r.pivot <= P:
            per[key][r.pivot] += 1
    for key, counts in per.items():
        counts = counts[1:]
        per[key] = counts
        over = [i + 1 for i, c in enumerate(counts) if c > 1]
        if over:
            viol.append(Violation(
                "IRC003", name, 0,
                f"{key} read {max(counts)} times in pivot {over[0]} "
                "(declared: at most once a pivot)"))
    return viol, per


def check_lp_twin(device, lp=None, max_iters: int = 200,
                  select: Optional[Callable] = None) -> HotPathResult:
    """The device LP (``core.lp_kernel._solve``): in its pivot loop the
    one declared host read, once every pivot (IRC003); on a card one
    pricing launch (IRC002) and one BFRT select call (IRC003, the
    ``Selector``'s own count of its calls) a pivot.
    The record holds pivots against ``max_iters`` (the reference's trip
    count), and ``core.lp.solve_lp``'s answer on the same LP beside
    it.  ``select`` replaces the ``Selector`` class (a double)."""
    from repro_torch.core import lp_kernel
    from repro_torch.core.lp import _prep, solve_lp
    t0 = time.time()
    dev = torch.device(device)
    lp = lp if lp is not None else package_lp(256, 8)
    m, n = np.atleast_2d(lp[1]).shape
    name = f"lp_kernel.solve@m{m}_n{n}"
    viol: List[Violation] = []
    arrs, _, _, _, start = _prep(*lp, None, None)
    cf, A, l, u = arrs

    def t(a, dtype=torch.float64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)
    args = (t(cf), t(A), t(l), t(u), t(start[0], torch.int64),
            t(start[1], torch.bool), max_iters)
    untraced_s = _timed(dev, lambda: lp_kernel._solve(*args))[1]
    with contextlib.ExitStack() as es:
        if select is not None:
            saved = lp_kernel.Selector
            lp_kernel.Selector = select
            es.callback(setattr, lp_kernel, "Selector", saved)
        with OpTrace(dev, watch={"A": args[1]}) as tr:
            out, traced_s = _timed(dev, lambda: lp_kernel._solve(*args))
    loop = "lp_kernel._solve"
    P = tr.pivots[loop]
    v, per = _pivot_read_violations(name, tr, loop)
    viol += v
    counts = per.get("_solve.<locals>.read:cpu", [0] * P)
    missing = [i + 1 for i, c in enumerate(counts) if c != 1]
    if missing:
        viol.append(Violation(
            "IRC003", name, 0,
            f"the declared read ran {counts[missing[0] - 1]} times in "
            f"pivot {missing[0]} (declared: exactly once a pivot)"))
    rec = {"hot_path": name, "m": m, "n": n, "max_iters": max_iters,
           "pivots": P, "status": out[0], "obj": out[2],
           "traced_s": traced_s, "untraced_s": untraced_s,
           "trace_cost_s_per_pivot": (traced_s - untraced_s) / max(P, 1),
           "host_reads": len(tr.reads),
           "host_reads_in_loop": sum(r.hot is not None for r in tr.reads),
           "host_reads_per_pivot": sum(
               r.hot is not None for r in tr.reads) / max(P, 1),
           "ops_per_pivot": tr.n_ops / max(P, 1),
           "dense_passes_per_pivot": round(
               sum(tr.passes("A", P).values()), 6)}
    if dev.type == "cuda":
        price, bfrt_launches, sel = tr.launches_per_pivot()
        bad_p = [i + 1 for i, k in enumerate(price) if k != 1]
        bad_s = [i + 1 for i, k in enumerate(sel) if k != 1]
        if bad_p:
            viol.append(Violation(
                "IRC002", name, 0,
                f"pricing launched {price[bad_p[0] - 1]} times in pivot "
                f"{bad_p[0]} (declared: once a pivot, csrc/pricing.cu)"))
        if bad_s:
            viol.append(Violation(
                "IRC003", name, 0,
                f"the BFRT select was called {sel[bad_s[0] - 1]} times in "
                f"pivot {bad_s[0]} (declared: one select call a pivot, "
                "csrc/bfrt.cu)"))
        rec.update(pricing_launches_per_pivot=sum(price) / max(P, 1),
                   select_calls_per_pivot=sum(sel) / max(P, 1),
                   bfrt_launches_per_pivot=sum(bfrt_launches) / max(P, 1))
    twin = solve_lp(*lp, max_iters=max_iters, device=dev)
    rec.update(solve_lp_status=twin.status, solve_lp_obj=twin.obj,
               solve_lp_pivots=twin.iters)
    return HotPathResult(name, time.time() - t0, rec, viol)


def check_lp_dist(ctx: Ctx, lp=None, max_iters: int = 500,
                  budget=None) -> HotPathResult:
    """``core.distributed.solve_lp_dist``: in its pivot loop only the
    declared reads (IRC003) -- ``rep.cpu()`` once a pivot, the refresh's
    read at most once, ``_any_rank`` only with a budget on more than one
    rank --, and the pq step's bytes a pivot within the budget
    (IRC004); on a card one pricing launch a pivot that reaches pricing
    (IRC002)."""
    from repro_torch.core.distributed import (GATHER_K, NUM_BUCKETS,
                                              solve_lp_dist)
    from repro_torch.kernels import pricing
    t0 = time.time()
    lp = lp if lp is not None else package_lp(512, 8, seed=1)
    m, n = np.atleast_2d(lp[1]).shape
    name = f"distributed.solve_lp_dist@{ctx.label}" + \
        ("_budget" if budget is not None else "")
    def solve():
        return solve_lp_dist(*lp, mesh=ctx.mesh, max_iters=max_iters,
                             budget=budget, device=ctx.device)
    untraced_s = _timed(ctx.device, solve)[1]
    launched = pricing.launches
    with OpTrace(ctx.device) as tr:
        res, traced_s = _timed(ctx.device, solve)
    loop = "distributed.solve_lp_dist"
    P = tr.pivots[loop]
    viol, per = _pivot_read_violations(name, tr, loop)
    reads = per.get("solve_lp_dist:cpu", [])
    short = [i + 1 for i, c in enumerate(reads[:-1]) if c != 1]
    if short:
        viol.append(Violation(
            "IRC003", name, 0,
            f"rep.cpu() ran {reads[short[0] - 1]} times in pivot "
            f"{short[0]} (declared: once every pivot that prices)"))
    agree = per.get("_any_rank:cpu", [])
    if sum(agree) and not (ctx.p > 1 and budget is not None):
        viol.append(Violation(
            "IRC003", name, 0,
            f"_any_rank read {sum(agree)} times without a budget on more "
            "than one rank"))
    in_loop = [r for r, _ in tr.collectives if 1 <= r.pivot <= P]
    st = collectives.collective_stats(in_loop, per=max(P, 1))
    budget_b = pq_collective_budget(ctx.p, m + 1, NUM_BUCKETS, GATHER_K)
    if st.total_bytes > budget_b:
        viol.append(Violation(
            "IRC004", name, 0,
            f"per-pivot collective bytes {st.total_bytes:.3e} exceed the "
            f"declared budget {budget_b:.3e}"))
    priced = sum(reads)
    rec = {"hot_path": name, "p": ctx.p, "m": m, "n": n,
           "max_iters": max_iters, "pivots": P, "status": res.status,
           "obj": res.obj, "iters": res.iters, "traced_s": traced_s,
           "untraced_s": untraced_s,
           "trace_cost_s_per_pivot": (traced_s - untraced_s) / max(P, 1),
           "declared_reads": {k: sum(v) for k, v in per.items()},
           "host_reads_in_loop": sum(r.hot is not None for r in tr.reads),
           "host_reads_per_pivot": sum(
               r.hot is not None for r in tr.reads) / max(P, 1),
           "collective_bytes_per_pivot": st.merged(),
           "collective_counts": dict(st.count_by_kind),
           "budget_bytes": float(budget_b),
           "ops_per_pivot": tr.n_ops / max(P, 1)}
    if ctx.device.type == "cuda":
        price = pricing.launches - launched
        if price != priced:
            viol.append(Violation(
                "IRC002", name, 0,
                f"{price} pricing launches for {priced} priced pivots "
                "(declared: one csrc/pricing.cu launch a priced pivot)"))
        rec["pricing_launches_per_pivot"] = price / max(P, 1)
    return HotPathResult(name, time.time() - t0, rec, viol)


def check_lp_batch(device, K: int = 4) -> HotPathResult:
    """The batched LP engine's plain version
    (``kernels.lp_batch.lp_batch_plain``): one device, no collective
    (IRC001), float32 kept (IRC005); its host reads are recorded (its
    lockstep loop is not a registered pivot loop)."""
    from repro_torch.core.lp import _prep
    from repro_torch.kernels.lp_batch import lp_batch_plain
    t0 = time.time()
    c, A_t, bl, bu, ub = package_lp(16, 4, seed=2)
    arrs, _, m, n, start = _prep(c, A_t, bl, bu, ub, None, None)
    cf, A, l, u = arrs
    N = n + m
    name = f"lp_batch.plain@m{m}_n{n}_K{K}"
    rows = []
    for k in range(K):
        uk = u.copy()
        uk[k] = 0.0                      # the lanes' bound variants
        rows.append(np.concatenate([
            l, uk, [1e-7], start[0], start[1].astype(np.float64), [1.0],
            [K * 64.0]]))
    pack = np.stack(rows)
    viol: List[Violation] = []
    rec = {"hot_path": name, "m": m, "n": n, "K": K}
    for dt in (torch.float64, torch.float32):
        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=device)
        with OpTrace(device, f64=dt == torch.float32) as tr:
            out = lp_batch_plain(t(cf), t(A), t(pack), max_iters=64,
                                 refactor_every=50)
        if dt == torch.float32:
            viol += _f64_violations(name, tr)
            continue
        viol += _collective_violations(name, tr, "the batched LP engine")
        rec.update(host_reads=len(tr.reads), ops=tr.n_ops,
                   statuses=out[:, 2 * N + 2 * m + 1].tolist()
                   if out.shape[1] > 2 * N + 2 * m + 1 else None)
    rec["N"] = N
    return HotPathResult(name, time.time() - t0, rec, viol)


def check_kernel_pricing(device, m: int = 4, n: int = 4096
                         ) -> HotPathResult:
    """Pricing (the plain version on the CPU, ``Pricer`` on a card): no
    host read (IRC003), float32 kept (IRC005)."""
    from repro_torch.kernels.pricing import Pricer
    t0 = time.time()
    name = f"kernels.pricing@m{m}_n{n}"
    A, d, lo, hi, state, rhos = _pq_inputs(m, n, seed=3)
    hi = np.where(np.isinf(hi), 1e30, hi)
    viol: List[Violation] = []
    for dt in (torch.float64, torch.float32):
        def t(a, dtype=dt):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)
        price = Pricer(t(A), t(lo), t(hi))
        with OpTrace(device, f64=dt == torch.float32) as tr:
            price(t(rhos[0]), t(d), t(state, torch.int32),
                  t(np.ones(1)))
        viol += _undeclared_reads(name, tr, hot_only=False)
        if dt == torch.float32:
            viol += _f64_violations(name, tr)
    return HotPathResult(name, time.time() - t0,
                         {"hot_path": name, "m": m, "n": n}, viol)


def check_kernel_segstats(device, n: int = 4096, k: int = 4
                          ) -> HotPathResult:
    """Segment statistics (the plain version on the CPU, the kernel on a
    card): no host read (IRC003), float32 kept by the plain version
    (IRC005; the card's kernel takes float64 only, by design)."""
    from repro_torch.kernels.segstats import segment_stats
    t0 = time.time()
    name = f"kernels.segstats@n{n}_k{k}"
    rng = np.random.default_rng(4)
    vals = rng.normal(size=(n, k))
    ids = np.sort(rng.integers(0, 64, n))
    viol: List[Violation] = []
    dtypes = (torch.float64,) if torch.device(device).type == "cuda" \
        else (torch.float64, torch.float32)
    for dt in dtypes:
        v = torch.as_tensor(vals, dtype=dt, device=device)
        i = torch.as_tensor(ids, dtype=torch.int64, device=device)
        with OpTrace(device, f64=dt == torch.float32) as tr:
            segment_stats(v, i, 64)
        viol += _undeclared_reads(name, tr, hot_only=False)
        if dt == torch.float32:
            viol += _f64_violations(name, tr)
    return HotPathResult(name, time.time() - t0,
                         {"hot_path": name, "n": n, "k": k}, viol)


def check_split_descent(device, batch: int = 1024) -> HotPathResult:
    """The batched split-tree descent (``kernels.split_tree
    .descend_batch``: one launch on a card, no host read (IRC003);
    float64 by design).  On the CPU it runs ``descend_batch_plain``,
    whose walk ends when no row is live: a host read a level, recorded
    here and not held (no pivot loop runs it)."""
    from repro_torch.core import partitioner
    from repro_torch.kernels.split_tree import descend_batch
    t0 = time.time()
    rng = np.random.default_rng(5)
    X = rng.normal(size=(4096, 3))
    tree = partitioner.fit(X, backend="kdtree", d_f=60, device="cpu").tree
    T = torch.as_tensor(rng.normal(size=(batch, 3)), dtype=torch.float64,
                        device=device)
    packed = tree.device_packed(device)
    name = f"split_tree.descend_batch@b{batch}_N{tree.num_nodes}"
    with OpTrace(device) as tr:
        descend_batch(T, packed)
    viol = []
    if torch.device(device).type == "cuda":
        viol += _undeclared_reads(name, tr, hot_only=False)
    return HotPathResult(name, time.time() - t0,
                         {"hot_path": name, "batch": batch,
                          "host_reads": len(tr.reads)}, viol)


# -------------------------------------------------------------- the grids


GRID_SHAPES = {"host": (8, 1 << 12), "card": (8, 1 << 16)}


def _dist_checks(ctx: Ctx, grid: str, lp=None, max_iters: int = 500
                 ) -> List[HotPathResult]:
    from repro_torch.core.guard import SolveBudget
    m, n = GRID_SHAPES[grid]
    out = [check_pq_step(ctx, m, n), check_update_step(ctx, m, n),
           check_refresh_step(ctx, m, n), check_lp_dist(ctx, lp, max_iters)]
    if ctx.p > 1:
        out.append(check_lp_dist(ctx, lp, max_iters,
                                 budget=SolveBudget(deadline_s=600.0)))
    return out


@contextlib.contextmanager
def world1(device, backend: str):
    """A world of one rank in this process (``backend`` over a
    ``HashStore``) and its (1, 1) mesh; a world of one rank that is up
    already is used and left up."""
    from torch.distributed.device_mesh import init_device_mesh
    mine = not dist.is_initialized()
    if mine:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1,
                                timeout=datetime.timedelta(seconds=120))
    elif dist.get_world_size() != 1:
        raise RuntimeError("a process group of more than one rank is up")
    try:
        mesh = init_device_mesh(torch.device(device).type, (1, 1),
                                mesh_dim_names=("data", "model"))
        yield Ctx(mesh, torch.device(device), 1, 0)
    finally:
        if mine:
            dist.destroy_process_group()


def _host_checks(ctx: Ctx) -> List[HotPathResult]:
    return _dist_checks(ctx, "host")


def _rank_main(rank: int, world: int, store: str, out_dir: str,
               checks: Callable) -> None:
    """A spawned rank of a gloo world: ``checks(ctx)``, pickled to
    ``out_dir``."""
    from torch.distributed.device_mesh import init_device_mesh
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=120))
        mesh = init_device_mesh("cpu", (1, world),
                                mesh_dim_names=("data", "model"))
        res = checks(Ctx(mesh, torch.device("cpu"), world, rank))
        dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    # repro: allow[REPRO004] spawned rank body: the traceback is written
    # for the parent, which raises it, and the error is re-raised here
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


SPAWN_JOIN_S = 180


def spawn_world(world: int = 2, checks: Callable = _host_checks
                ) -> List[List[HotPathResult]]:
    """``checks(ctx)`` (default: the host grid's distributed checks) on
    a spawned gloo world of ``world`` ranks (a ``FileStore`` in a
    temporary directory, removed after; ``checks`` a module-level
    function, which the ranks import): each rank's results in rank order.
    Raises with the ranks' tracebacks if one fails or the world is not
    done within ``SPAWN_JOIN_S``."""
    import multiprocessing as mp
    out_dir = tempfile.mkdtemp(prefix="repro_torch_contracts_")
    try:
        ctx = mp.get_context("spawn")
        store = os.path.join(out_dir, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, store, out_dir, checks))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + SPAWN_JOIN_S
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
        errs = [Path(out_dir, e).read_text()
                for e in sorted(os.listdir(out_dir)) if e.endswith(".err")]
        if hung or errs or any(p.exitcode for p in procs):
            raise RuntimeError(
                f"contracts world of {world}: {len(hung)} ranks hung, exit "
                f"codes {[p.exitcode for p in procs]}\n" + "\n".join(errs))
        res = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                res.append(pickle.load(f))
        return res
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def run_contracts(grid: str = "host", *, lp=None, max_iters: int = 500
                  ) -> Tuple[List[Violation], List[dict], float]:
    """Every hot-path check over the requested grid.

    ``"host"``: on the CPU, a world of one rank in this process and a
    gloo world of two spawned over loopback, then the single-device
    paths.  ``"card"``: on CUDA, a world of one rank on NCCL and the
    single-device paths.  ``lp`` (c, A_t, bl, bu, ub) is the LP the
    device LP and ``solve_lp_dist`` solve, with ``max_iters`` (default
    a package LP).
    ``"none"``: nothing (the CLI's lint-only lane).  ``"pod"`` needs the
    production mesh, which the port does not have (``ValueError``).
    Returns (violations, per-hot-path records, total wall seconds)."""
    t0 = time.time()
    results: List[HotPathResult] = []
    if grid == "none":
        return [], [], 0.0
    if grid == "pod":
        raise ValueError("grid 'pod' needs the production mesh "
                         "(launch/mesh.py), which the port does not have")
    if grid == "host":
        device, backend = "cpu", "gloo"
    elif grid == "card":
        if not torch.cuda.is_available():
            raise RuntimeError("grid 'card' needs a CUDA device")
        torch.cuda.set_device(0)
        device, backend = "cuda", "nccl"
    else:
        raise ValueError(f"unknown grid {grid!r}")
    with world1(device, backend) as ctx:
        results += _dist_checks(ctx, grid, lp, max_iters)
    if grid == "host":
        ranks = spawn_world(2)
        for r, res in enumerate(ranks):
            for hp in res:
                if r:
                    hp.name += f"/rank{r}"
                    hp.record["hot_path"] = hp.name
                    hp.violations = [dataclasses.replace(v, path=hp.name)
                                     for v in hp.violations]
                results.append(hp)
    results.append(check_lp_twin(device, lp, max_iters=max_iters))
    results.append(check_lp_batch(device))
    results.append(check_kernel_pricing(device))
    results.append(check_kernel_segstats(device))
    results.append(check_split_descent(device))
    violations = [v for r in results for v in r.violations]
    records = [dict(r.record, wall_s=round(r.wall_s, 3)) for r in results]
    return violations, records, time.time() - t0

