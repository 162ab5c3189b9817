"""Concurrency contract checker of the port (``repro.analysis.concurrency``
ported as it is) — static rules for the shared-state serving path.

The serving tier runs one resident engine under concurrent
sessions; every shared mutable structure now declares its guarding lock
and this pass holds the code to those declarations:

``REPRO008`` unlocked mutation of a registered shared attribute.  A
    class declares ``__guarded_by__ = {"attr": "_lock"}``; any write or
    mutating method call on ``self.attr`` outside a ``with self._lock``
    (or a ``@guarded_by("_lock")`` body) races readers.
``REPRO009`` check-then-act on a cache dict: the same function reads a
    cache-ish receiver (``.get`` / ``in`` / subscript load) in one lock
    scope and inserts into it in a *different* scope — the classic
    lost-update / duplicate-populate window between probe and insert.
``REPRO010`` process-global mutable state (module ``SHARED_MUTABLE``
    registry, or module-level dict/list/set literals in lock-aware
    files) mutated with no lock held.
``REPRO011`` solver dispatch under a lock: calling a
    ``solve_lp_batch``-class entry point while holding any lock
    serializes every concurrent solve behind a cache mutex (and a
    blocked owner parks all waiters).  Build/solve OUTSIDE the lock;
    publish under it.
``REPRO012`` torn stats: two or more fields of the same ``*stats*``
    object mutated with no lock held — a concurrent snapshot reads a
    half-updated pair (hits bumped, misses not).

Registries the checker consumes (all declarative, zero runtime cost):

* class attribute ``__guarded_by__ = {"attr": "lock_attr", ...}``
* module tuple ``SHARED_MUTABLE = ("_ACTIVE", ...)``
* decorator ``@guarded_by("_lock")`` / ``@racecheck.guarded_by("_lock")``
  — asserts the named lock is held for the whole body (callers carry
  the REPRO008 obligation).

Scope: REPRO008/009/011 run everywhere; REPRO010/012 only where they
can be meaningful — the strict serving-path files (``core/qcache.py``,
``core/distributed.py``, ``core/lp_batch.py``, ``runtime/faults.py``,
``runtime/racecheck.py``, ``serving/*``) plus any file that is
*lock-aware* (constructs a ``threading`` lock or registers
``SHARED_MUTABLE``).  Single-threaded scripts stay out of scope.

Suppression and ratchet are shared with the project lint: append
``# repro: allow[REPROxxx] <justification>`` on the flagged line or the
comment block above it; counts pin into
``src/repro_torch/analysis/baseline.json``.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis import lint
from repro_torch.analysis.report import Violation

CONCURRENCY_RULES: Dict[str, str] = {
    "REPRO008": "unlocked mutation of a shared attribute registered in "
                "__guarded_by__",
    "REPRO009": "check-then-act race: cache read and insert in separate "
                "lock scopes",
    "REPRO010": "process-global mutable state mutated without a lock "
                "held",
    "REPRO011": "solver dispatch while holding a lock (no solves under "
                "a cache mutex)",
    "REPRO012": "non-atomic multi-field stats update (torn snapshot "
                "window)",
}

#: rules REPRO001..012 — the full project rule set for docs/tests.
ALL_RULES: Dict[str, str] = {**lint.RULES, **CONCURRENCY_RULES}

# A With context expression whose trailing name component looks like a
# synchronisation primitive.  Meshes / files / tempdirs don't match.
_LOCKISH_RE = re.compile(r"lock|mutex|mtx|cond|sem|meter", re.IGNORECASE)

# threading-primitive constructors: their presence makes a file
# "lock-aware" (REPRO010/012 in scope); binding one at module level
# must NOT itself register as shared mutable state.
_LOCK_CTORS = ("Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore", "Event", "Barrier",
               "InstrumentedLock", "InstrumentedRLock")

# Mutating methods on containers/objects (REPRO008 receiver writes).
_MUTATORS = frozenset({
    "append", "add", "extend", "insert", "update", "setdefault", "pop",
    "popitem", "remove", "discard", "clear", "move_to_end", "sort",
    "reverse", "appendleft", "popleft",
})
# The subset that *inserts* (REPRO009's act half).
_INSERTERS = frozenset({"append", "add", "extend", "insert", "update",
                        "setdefault", "appendleft"})

# Receivers that conventionally hold a cache (REPRO009 eligibility).
_CACHEISH_RE = re.compile(r"cache|entr|inflight|building|prep|memo",
                          re.IGNORECASE)

# Dispatch entry points that must never run under a held lock.
# (the reference's names, and the port's own entry points: the device LP
# and the batched engine's per-class launch workspace)
_DISPATCH_CALLEES = frozenset({
    "solve_lp_batch", "solve_lp", "solve_lp_np", "solve_lp_dist",
    "solve_ilp", "dual_reducer", "progressive_shading", "sketch_refine",
    "solve_lp_kernel", "LaneSolver",
})

# Module-level constructors whose result is shared mutable state.
_MUTABLE_CTORS = ("dict", "list", "set", "OrderedDict", "defaultdict",
                  "deque", "Counter")

# Files where REPRO010/012 always apply (the audited serving path).
_STRICT_SUFFIXES = ("core/qcache.py", "core/distributed.py",
                    "core/lp_batch.py", "runtime/faults.py",
                    "runtime/racecheck.py")


def _is_strict(path: str) -> bool:
    p = path.replace(os.sep, "/")
    return p.endswith(_STRICT_SUFFIXES) or "/serving/" in p


def _last(qual: str) -> str:
    return qual.split(".")[-1] if qual else ""


class ConcurrencyLinter(lint.Linter):
    """Single-file concurrency pass; reuses the lint suppression /
    emission machinery but walks its own rule set."""

    # ------------------------------------------------------------- run

    def run(self) -> List[Violation]:
        self._collect_registry()
        strict = _is_strict(self.path)
        self._globals_in_scope = strict or self._lock_aware \
            or bool(self._shared_mutable)
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                guarded = self._guarded_by.get(node.name, {})
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self._check_function(item, guarded=guarded,
                                             is_method=True)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_function(node, guarded={}, is_method=False)
        return self.violations

    # ------------------------------------------------------ registries

    def _collect_registry(self) -> None:
        self._guarded_by: Dict[str, Dict[str, str]] = {}
        self._shared_mutable: Set[str] = set()
        self._mutable_globals: Set[str] = set()
        self._lock_aware = False

        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                callee = _last(lint._qualname(node.func))
                if callee in _LOCK_CTORS:
                    self._lock_aware = True

        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                g = self._class_guarded(node)
                if g:
                    self._guarded_by[node.name] = g
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                if len(targets) != 1 or \
                        not isinstance(targets[0], ast.Name):
                    continue
                name, value = targets[0].id, node.value
                if name == "SHARED_MUTABLE" and \
                        isinstance(value, (ast.Tuple, ast.List)):
                    for elt in value.elts:
                        if isinstance(elt, ast.Constant) and \
                                isinstance(elt.value, str):
                            self._shared_mutable.add(elt.value)
                elif self._is_mutable_literal(value):
                    self._mutable_globals.add(name)

    @staticmethod
    def _class_guarded(cls: ast.ClassDef) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for item in cls.body:
            if isinstance(item, ast.Assign) and len(item.targets) == 1 \
                    and isinstance(item.targets[0], ast.Name) \
                    and item.targets[0].id == "__guarded_by__" \
                    and isinstance(item.value, ast.Dict):
                for k, v in zip(item.value.keys, item.value.values):
                    if isinstance(k, ast.Constant) and \
                            isinstance(v, ast.Constant):
                        out[str(k.value)] = str(v.value)
        return out

    @staticmethod
    def _is_mutable_literal(value: Optional[ast.AST]) -> bool:
        if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.ListComp,
                              ast.DictComp, ast.SetComp)):
            return True
        if isinstance(value, ast.Call):
            callee = _last(lint._qualname(value.func))
            return callee in _MUTABLE_CTORS
        return False

    # --------------------------------------------------- function walk

    def _check_function(self, fn: ast.AST, *, guarded: Dict[str, str],
                        is_method: bool) -> None:
        init_like = getattr(fn, "name", "") in (
            "__init__", "__new__", "__post_init__")
        declared_globals: Set[str] = set()
        for n in ast.walk(fn):
            if isinstance(n, ast.Global):
                declared_globals.update(n.names)
        local = lint._local_bindings(fn) - declared_globals

        deco_locks = self._decorator_locks(fn)
        # events: (node, held_locks, innermost_lock_scope_id)
        reads: Dict[str, List[Tuple[int, ast.AST]]] = {}
        inserts: Dict[str, List[Tuple[int, ast.AST]]] = {}
        stats_muts: Dict[str, List[Tuple[str, bool, ast.AST]]] = {}
        saw_lock_with = [bool(deco_locks)]
        self_name = self._self_name(fn) if is_method else None

        def root_of(node: ast.AST) -> str:
            q = lint._qualname(node)
            return q.split(".")[0] if q else ""

        def note_self_mutation(target: ast.AST, held: frozenset,
                               node: ast.AST) -> None:
            """REPRO008: `target` is an attribute chain rooted at self."""
            q = lint._qualname(target)
            parts = q.split(".")
            if len(parts) < 2:
                return
            attr = parts[1]
            if init_like or not guarded or attr not in guarded:
                return
            lock = guarded[attr]
            if lock not in held:
                self._emit(
                    "REPRO008", node,
                    f"`{q}` is guarded by `self.{lock}` "
                    f"(__guarded_by__) but mutated without it held")

        def note_stats_mutation(target: ast.AST, held: frozenset,
                                node: ast.AST) -> None:
            """REPRO012 candidate: field write `recv.field = ...`."""
            q = lint._qualname(target)
            parts = q.split(".")
            if len(parts) >= 2:
                recv, field = ".".join(parts[:-1]), parts[-1]
                root = parts[0]
                rooted = (root == self_name) or \
                    (root in self._mutable_globals or
                     root in self._shared_mutable)
                if rooted and "stats" in recv.lower():
                    stats_muts.setdefault(recv, []).append(
                        (field, bool(held), node))

        def note_global_mutation(name: str, held: frozenset,
                                 node: ast.AST) -> None:
            if name in local:
                return
            registered = self._shared_mutable | self._mutable_globals
            if name not in registered:
                return
            if not self._globals_in_scope:
                return
            if not held:
                self._emit(
                    "REPRO010", node,
                    f"module-global `{name}` is shared mutable state; "
                    f"mutation needs a lock (or a thread-local copy)")

        def note_container(kind: str, recv_node: ast.AST,
                           scope: int, node: ast.AST) -> None:
            q = lint._qualname(recv_node)
            if not q:
                return
            root = q.split(".")[0]
            attr = q.split(".")[1] if root == self_name and \
                "." in q else _last(q)
            eligible = bool(_CACHEISH_RE.search(_last(q))) or \
                (root == self_name and attr in guarded)
            if not eligible:
                return
            book = reads if kind == "read" else inserts
            book.setdefault(q, []).append((scope, node))

        def handle_target(t: ast.AST, held: frozenset, scope: int,
                          node: ast.AST) -> None:
            if isinstance(t, (ast.Tuple, ast.List)):
                for elt in t.elts:
                    handle_target(elt, held, scope, node)
            elif isinstance(t, ast.Starred):
                handle_target(t.value, held, scope, node)
            elif isinstance(t, ast.Attribute):
                if root_of(t) == self_name and self_name:
                    note_self_mutation(t, held, node)
                    note_stats_mutation(t, held, node)
                elif root_of(t) in self._shared_mutable | \
                        self._mutable_globals:
                    note_global_mutation(root_of(t), held, node)
                    note_stats_mutation(t, held, node)
            elif isinstance(t, ast.Subscript):
                base = t.value
                broot = root_of(base)
                if broot == self_name and self_name:
                    note_self_mutation(base, held, node)
                    note_container("insert", base, scope, node)
                elif isinstance(base, ast.Name):
                    note_global_mutation(base.id, held, node)
                    note_container("insert", base, scope, node)
            elif isinstance(t, ast.Name):
                if t.id in declared_globals:
                    note_global_mutation(t.id, held, node)

        def walk(node: ast.AST, held: frozenset, scope: int) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                # a nested def may run later, outside the current lock
                body = node.body if isinstance(node.body, list) \
                    else [node.body]
                for b in body:
                    walk(b, frozenset(), 0)
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                new_locks = set()
                for item in node.items:
                    name = _last(lint._qualname(item.context_expr))
                    if name and _LOCKISH_RE.search(name):
                        new_locks.add(name)
                if new_locks:
                    saw_lock_with[0] = True
                    held = held | frozenset(new_locks)
                    scope = id(node)
                for b in node.body:
                    walk(b, held, scope)
                return

            if isinstance(node, ast.Assign):
                for t in node.targets:
                    handle_target(t, held, scope, node)
            elif isinstance(node, ast.AugAssign):
                handle_target(node.target, held, scope, node)
            elif isinstance(node, ast.AnnAssign) and node.value:
                handle_target(node.target, held, scope, node)
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    handle_target(t, held, scope, node)
            elif isinstance(node, ast.Call):
                callee = _last(lint._qualname(node.func))
                if callee in _DISPATCH_CALLEES and held:
                    self._emit(
                        "REPRO011", node,
                        f"`{callee}` dispatched while holding "
                        f"lock(s) {sorted(held)} — solve outside the "
                        f"lock, publish under it")
                if isinstance(node.func, ast.Attribute):
                    recv = node.func.value
                    if node.func.attr in _MUTATORS:
                        rroot = root_of(recv)
                        if rroot == self_name and self_name:
                            note_self_mutation(recv, held, node)
                        elif isinstance(recv, ast.Name):
                            note_global_mutation(recv.id, held, node)
                        if node.func.attr in _INSERTERS:
                            note_container("insert", recv, scope, node)
                    if node.func.attr == "get":
                        note_container("read", recv, scope, node)
            elif isinstance(node, ast.Compare):
                for op, comparator in zip(node.ops, node.comparators):
                    if isinstance(op, (ast.In, ast.NotIn)):
                        note_container("read", comparator, scope, node)
            elif isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, ast.Load):
                note_container("read", node.value, scope, node)

            for child in ast.iter_child_nodes(node):
                walk(child, held, scope)

        base_held = frozenset(deco_locks)
        base_scope = -1 if deco_locks else 0
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for b in body:
            walk(b, base_held, base_scope)

        # REPRO009: per-receiver, a read and an insert in different
        # innermost lock scopes (at least one inside a lock) means the
        # decision can go stale before the act.  Emitted once per
        # receiver at the function def, so one suppression covers the
        # whole claim/publish protocol.
        if saw_lock_with[0] and not init_like:
            for recv in sorted(set(reads) & set(inserts)):
                r_scopes = {s for s, _ in reads[recv]}
                i_scopes = {s for s, _ in inserts[recv]}
                split = any(r != i and (r != 0 or i != 0)
                            for r in r_scopes for i in i_scopes)
                if split:
                    self._emit(
                        "REPRO009", fn,
                        f"`{recv}` is probed and inserted under "
                        f"different lock scopes in "
                        f"`{getattr(fn, 'name', '<lambda>')}` — the "
                        f"check can go stale before the act")

        # REPRO012: >= 2 distinct fields of one stats receiver written
        # without a lock.
        if self._globals_in_scope and not init_like:
            for recv, muts in sorted(stats_muts.items()):
                unlocked = [(f, nd) for f, locked, nd in muts
                            if not locked]
                fields = {f for f, _ in unlocked}
                if len(fields) >= 2:
                    first = min(unlocked, key=lambda p: p[1].lineno)[1]
                    self._emit(
                        "REPRO012", first,
                        f"fields {sorted(fields)} of `{recv}` mutated "
                        f"without a lock — a concurrent snapshot sees "
                        f"a torn update")

    # ----------------------------------------------------------- helpers

    @staticmethod
    def _self_name(fn: ast.AST) -> Optional[str]:
        args = fn.args
        pos = args.posonlyargs + args.args
        return pos[0].arg if pos else None

    @staticmethod
    def _decorator_locks(fn: ast.AST) -> Set[str]:
        locks: Set[str] = set()
        for deco in getattr(fn, "decorator_list", ()):
            if isinstance(deco, ast.Call) and \
                    _last(lint._qualname(deco.func)) == "guarded_by" \
                    and deco.args and \
                    isinstance(deco.args[0], ast.Constant):
                locks.add(str(deco.args[0].value))
        return locks


# ------------------------------------------------------------- entry points


def check_source(src: str, path: str = "<memory>") -> List[Violation]:
    """Concurrency-check one source string (unit-test entry point)."""
    try:
        return ConcurrencyLinter(src, path).run()
    except SyntaxError as e:
        return [Violation("REPRO000", path, e.lineno or 0,
                          f"syntax error: {e.msg}")]


def check_file(path: str, root: str = ".") -> List[Violation]:
    with open(path) as f:
        src = f.read()
    return check_source(src, os.path.relpath(path, root))


def check_paths(paths: Sequence[str], root: str = "."
                ) -> Tuple[List[Violation], int]:
    """Concurrency-check every ``*.py`` under ``paths``.
    Returns (violations, files_checked)."""
    files = lint.python_files(paths, root)
    out: List[Violation] = []
    for f in files:
        out.extend(check_file(f, root))
    return out, len(files)
