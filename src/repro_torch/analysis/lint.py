"""Project lint of the port (counterpart of ``repro.analysis.lint``): the
footgun classes the reference paid for, as named AST rules in the form
each takes in torch.

``REPRO001`` no counterpart.  The reference flags ``lax.cond``/
    ``lax.switch`` branches closing over enclosing state (branch jaxprs
    are cached by function identity).  Torch traces no branch functions:
    a Python ``if`` runs the branch it takes, so nothing can replay a
    stale closure.  The id stays in :data:`RULES` so the two rule sets
    line up; nothing fires it.
``REPRO002`` silent float32 in the float64 solver modules.  Two halves:
    float literals beyond float32 range (the ``1e300`` sentinel class,
    which becomes ``inf`` in a float32 tensor), everywhere but the
    sanctioned ``core/distributed.py::big_sentinel``; and, in the LP/ILP
    modules that must stay float64 (:data:`_F64_MODULES`), a float tensor
    factory with no ``dtype=`` (``torch.tensor(<float>)``,
    ``torch.full(..., <float>)``, ``torch.zeros(n)`` ...), which gives
    torch's default float32.  Torch has no x64 switch, so the reference's
    ``jnp.float64``-reference half has nothing to guard here.
``REPRO003`` host reads inside the registered pivot loops
    (:data:`HOT_LOOPS`): ``.item()``, ``.cpu()``, ``.tolist()``,
    ``.numpy()`` and ``.to("cpu")``, in the loop itself or in a helper of
    the same module that the loop calls (transitively).  Each is a
    device-to-host round trip a pivot.  The declared reads carry
    ``allow[REPRO003] declared read: ...``; casts (``float()``,
    ``int()``, ``bool()``) are left to the traced contract IRC003, since
    statically a tensor cannot be told from a numpy scalar.
``REPRO004`` bare ``except Exception`` / ``except:`` outside the guard
    contract.
``REPRO005`` whole-column materialisation of a ``Relation``
    (``np.asarray(table[...])``, ``torch.as_tensor(rel[...])``, a full
    ``[:]`` slice of a column): defeats the out-of-core discipline.
``REPRO006`` un-budgeted solver loops: a ``for``/``while`` whose header
    mentions ``max_iters``/``max_pivots``/``max_nodes`` but whose body
    never consults a ``SolveBudget``.
``REPRO007`` cache writes under swallowed exceptions.

Suppression: append ``# repro: allow[REPROxxx] <justification>`` on the
flagged line or in the comment block directly above it.  The
justification is mandatory -- a bare allow is itself a violation of the
same rule.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.report import Violation

RULES: Dict[str, str] = {
    "REPRO001": "no counterpart: torch traces no lax.cond/lax.switch "
                "branch functions, so no branch can close over stale "
                "state (the id is kept; nothing fires it)",
    "REPRO002": "beyond-f32-range literal, or a float tensor factory "
                "without dtype= in a float64 solver module (torch's "
                "default float32)",
    "REPRO003": "host read (.item/.cpu/.tolist/.numpy/.to('cpu')) inside "
                "a registered pivot loop",
    "REPRO004": "bare `except Exception` outside the guard contract",
    "REPRO005": "whole-column materialisation of a streamed Relation",
    "REPRO006": "solver loop bounded by max_iters/pivots/nodes without "
                "charging a SolveBudget",
    "REPRO007": "cache write inside a broad exception handler / try — "
                "a swallowed failure can populate poisoned artifacts",
}

_SUPPRESS_RE = re.compile(r"#\s*repro:\s*allow\[(REPRO\d{3})\]\s*(.*)")

# REPRO002 (a): anything beyond float32 range is the 1e300 sentinel class;
# the sanctioned site is the sentinel's own function
_F32_MAX = 3.5e38  # repro: allow[REPRO002] the rule's own threshold
_F64_ALLOWED = (("core/distributed.py", "big_sentinel"),)
# REPRO002 (b): the modules whose arithmetic must stay float64
_F64_MODULES = ("core/lp.py", "core/lp_kernel.py", "core/lp_batch.py",
                "core/distributed.py", "core/ilp.py", "core/dual_reducer.py",
                "kernels/pricing.py", "kernels/bfrt.py", "kernels/lp_batch.py")
# factories whose float result takes torch's default dtype without dtype=
_FLOAT_FACTORIES = ("zeros", "ones", "empty", "rand", "randn", "linspace",
                    "logspace")
_VALUE_FACTORIES = ("tensor", "as_tensor", "scalar_tensor")

# REPRO003: the pivot loops, by file and qualified function name.
# "loop": the function's outermost for/while loops; "body": the whole
# function, which runs once a pivot.
HOT_LOOPS: Tuple[Tuple[str, str, str], ...] = (
    ("core/lp_kernel.py", "_solve", "loop"),
    ("core/distributed.py", "solve_lp_dist", "loop"),
    ("core/distributed.py", "BoundPQStep.__call__", "body"),
    ("core/distributed.py", "UpdateStep.__call__", "body"),
    ("core/distributed.py", "RefreshStep.__call__", "body"),
)
_HOST_READ_METHODS = ("item", "cpu", "tolist", "numpy")

# REPRO005: names that conventionally hold a (possibly streamed) Relation.
_RELATION_NAMES = ("table", "rel", "relation")
_NP_GATHER_CALLS = ("np.asarray", "np.array", "np.stack",
                    "np.column_stack", "np.vstack", "np.concatenate",
                    "numpy.asarray", "numpy.array", "numpy.stack",
                    "torch.as_tensor", "torch.tensor", "torch.stack",
                    "torch.from_numpy")

_BUDGET_TOKENS = ("max_iters", "max_pivots", "max_nodes")

# REPRO007: mutating methods on a receiver whose name mentions a cache.
_CACHE_WRITE_METHODS = ("store", "put", "populate", "insert")


def _qualname(node: ast.AST) -> str:
    """Dotted name of an expression ('torch.tensor'), '' if not a name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_relationish(node: ast.AST) -> bool:
    """Name/attribute that conventionally binds a Relation."""
    q = _qualname(node)
    if not q:
        return False
    last = q.split(".")[-1]
    return last in _RELATION_NAMES


def _path_is(path: str, suffixes: Iterable[str]) -> bool:
    p = path.replace(os.sep, "/")
    return any(p == s or p.endswith("/" + s) for s in suffixes)


def _function_params(fn: ast.AST) -> Set[str]:
    args = fn.args
    names = {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs}
    if args.vararg:
        names.add(args.vararg.arg)
    if args.kwarg:
        names.add(args.kwarg.arg)
    return names


def _local_bindings(fn: ast.AST) -> Set[str]:
    """Names bound inside ``fn`` (params, assignments, nested defs) —
    NOT descending into nested functions' own bodies for assignments."""
    bound = set(_function_params(fn))
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    stack = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            bound.add(node.name)
            continue                      # do not descend: own scope
        if isinstance(node, ast.Lambda):
            continue
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            bound.add(node.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for al in node.names:
                bound.add((al.asname or al.name).split(".")[0])
        elif isinstance(node, ast.ExceptHandler) and node.name:
            bound.add(node.name)
        stack.extend(ast.iter_child_nodes(node))
    return bound


def functions_by_qualname(tree: ast.AST) -> Dict[str, ast.AST]:
    """Every function of a module by its qualified name (``Cls.meth``,
    ``outer.<locals>.inner`` as Python's ``co_qualname`` writes it)."""
    out: Dict[str, ast.AST] = {}

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = prefix + child.name
                out[q] = child
                visit(child, q + ".<locals>.")
            elif isinstance(child, ast.ClassDef):
                visit(child, prefix + child.name + ".")
            else:
                visit(child, prefix)
    visit(tree, "")
    return out


def own_nodes(fn: ast.AST) -> Iterable[ast.AST]:
    """The nodes of ``fn``'s body, not descending into nested defs."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def hot_regions(tree: ast.AST, qualname: str, scope: str
                ) -> List[ast.AST]:
    """The statements of a registered pivot loop: the function's
    outermost for/while loops (``scope="loop"``) or the function itself
    (``"body"``); empty if the module has no such function."""
    fn = functions_by_qualname(tree).get(qualname)
    if fn is None:
        return []
    if scope == "body":
        return [fn]
    loops: List[ast.AST] = []
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.For, ast.While)):
            loops.append(node)
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))
    return sorted(loops, key=lambda n: n.lineno)


def _is_host_read(call: ast.Call) -> Optional[str]:
    """The host-read method a call makes (``"cpu"``, ``"to('cpu')"``
    ...), None if it makes none."""
    if not isinstance(call.func, ast.Attribute):
        return None
    attr = call.func.attr
    if attr in _HOST_READ_METHODS and not call.args and not call.keywords:
        return attr
    if attr == "to":
        targets = list(call.args[:1]) + [k.value for k in call.keywords
                                         if k.arg == "device"]
        for t in targets:
            if isinstance(t, ast.Constant) and t.value == "cpu":
                return "to('cpu')"
            if isinstance(t, ast.Call) and \
                    _qualname(t.func).endswith("device") and t.args and \
                    isinstance(t.args[0], ast.Constant) and \
                    t.args[0].value == "cpu":
                return "to('cpu')"
    return None


class Linter:
    """Single-file linter; :func:`lint_source` is the entry point."""

    def __init__(self, src: str, path: str):
        self.src = src
        self.path = path
        self.lines = src.splitlines()
        self.tree = ast.parse(src, filename=path)
        self.violations: List[Violation] = []

    # ------------------------------------------------------------- infra

    def _suppressed(self, rule: str, line: int) -> bool:
        """Trailing comment on the flagged line, or anywhere in the
        contiguous comment block immediately above it."""
        def _match(ln: int) -> bool:
            m = _SUPPRESS_RE.search(self.lines[ln - 1])
            return bool(m and m.group(1) == rule and m.group(2).strip())

        if 1 <= line <= len(self.lines) and _match(line):
            return True
        ln = line - 1
        while 1 <= ln <= len(self.lines) and \
                self.lines[ln - 1].lstrip().startswith("#"):
            if _match(ln):
                return True
            ln -= 1
        return False

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        if self._suppressed(rule, line):
            return
        self.violations.append(Violation(rule, self.path, line, message))

    # ------------------------------------------------------------ passes

    def run(self) -> List[Violation]:
        self._walk_rules()
        return self.violations

    def _walk_rules(self) -> None:
        f64_module = _path_is(self.path, _F64_MODULES)
        allowed_lines = self._f64_allowed_lines()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                self._check_relation_gather(node)     # REPRO005
                if f64_module:
                    self._check_default_float(node)   # REPRO002 (b)
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, float) and \
                    abs(node.value) >= _F32_MAX and \
                    node.lineno not in allowed_lines:
                self._emit("REPRO002", node,
                           f"literal {node.value!r} exceeds f32 range — "
                           "it becomes inf in a float32 tensor (derive the "
                           "sentinel from the dtype: big_sentinel)")
            if isinstance(node, ast.ExceptHandler):
                self._check_bare_except(node)         # REPRO004
            if isinstance(node, (ast.For, ast.While)):
                self._check_unbudgeted_loop(node)     # REPRO006
            if isinstance(node, ast.Subscript):
                self._check_full_slice(node)          # REPRO005 (b)
            if isinstance(node, ast.Try):
                self._check_cache_write_swallow(node)  # REPRO007
        self._check_hot_loop_reads()                  # REPRO003

    def _f64_allowed_lines(self) -> Set[int]:
        lines: Set[int] = set()
        fns = None
        for suffix, qual in _F64_ALLOWED:
            if not _path_is(self.path, (suffix,)):
                continue
            fns = fns or functions_by_qualname(self.tree)
            fn = fns.get(qual)
            if fn is not None:
                lines.update(range(fn.lineno, fn.end_lineno + 1))
        return lines

    # REPRO002 (b) ------------------------------------------------------
    def _check_default_float(self, call: ast.Call) -> None:
        q = _qualname(call.func)
        if not q.startswith("torch.") or q.count(".") != 1:
            return
        name = q.split(".")[1]
        if any(k.arg in ("dtype", None) for k in call.keywords):
            return                  # dtype=, or **kwargs that may hold it

        def floaty(a: ast.AST) -> bool:
            for sub in ast.walk(a):
                if isinstance(sub, ast.Constant) and \
                        isinstance(sub.value, float):
                    return True
                if isinstance(sub, ast.Call) and \
                        _qualname(sub.func) == "float":
                    return True
            return False

        if name in _FLOAT_FACTORIES:
            hit = True
        elif name in _VALUE_FACTORIES:
            hit = bool(call.args) and floaty(call.args[0])
        elif name == "full":
            fill = call.args[1] if len(call.args) > 1 else next(
                (k.value for k in call.keywords if k.arg == "fill_value"),
                None)
            hit = fill is not None and floaty(fill)
        elif name == "arange":
            hit = any(floaty(a) for a in call.args)
        else:
            hit = False
        if hit:
            self._emit("REPRO002", call,
                       f"{q}() without dtype= makes torch's default "
                       "float32 in a float64 solver module — pass dtype=")

    # REPRO003 ---------------------------------------------------------
    def _check_hot_loop_reads(self) -> None:
        regions = [(qual, r) for suffix, qual, scope in HOT_LOOPS
                   if _path_is(self.path, (suffix,))
                   for r in hot_regions(self.tree, qual, scope)]
        if not regions:
            return
        fns = functions_by_qualname(self.tree)
        seen: Set[int] = set()
        for qual, region in regions:
            owner = qual
            todo: List[Tuple[ast.AST, str]] = [(region, owner)]
            visited: Set[int] = set()
            while todo:
                node, where = todo.pop()
                nodes = own_nodes(node) if isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    else ast.walk(node)
                for sub in nodes:
                    if not isinstance(sub, ast.Call):
                        continue
                    what = _is_host_read(sub)
                    if what is not None and id(sub) not in seen:
                        seen.add(id(sub))
                        self._emit(
                            "REPRO003", sub,
                            f".{what} in the pivot loop {qual} (via "
                            f"{where}): a device-to-host read a pivot — "
                            "keep the value on the device, or declare the "
                            "read")
                    if isinstance(sub.func, ast.Name):
                        callee = self._resolve_local(fns, owner,
                                                     sub.func.id)
                        if callee is not None and \
                                id(callee) not in visited:
                            visited.add(id(callee))
                            todo.append((callee, sub.func.id))

    @staticmethod
    def _resolve_local(fns: Dict[str, ast.AST], owner: str,
                       name: str) -> Optional[ast.AST]:
        """A called name as a function of this module: nested in the
        owner (or its enclosing functions) first, then module level."""
        parts = owner.split(".<locals>.")
        while parts:
            fn = fns.get(".<locals>.".join(parts) + ".<locals>." + name)
            if fn is not None:
                return fn
            parts.pop()
        return fns.get(name)

    # REPRO004 ---------------------------------------------------------
    def _check_bare_except(self, node: ast.ExceptHandler) -> None:
        def broad(t: ast.AST) -> bool:
            return _qualname(t).split(".")[-1] in ("Exception",
                                                   "BaseException")
        ty = node.type
        if ty is None or broad(ty) or (
                isinstance(ty, ast.Tuple) and any(broad(e)
                                                  for e in ty.elts)):
            self._emit("REPRO004", node,
                       "bare except — narrow it, or tie it to the guard "
                       "ladder with an explicit suppression")

    # REPRO005 ---------------------------------------------------------
    def _check_relation_gather(self, call: ast.Call) -> None:
        q = _qualname(call.func)
        if q not in _NP_GATHER_CALLS:
            return
        for a in call.args:
            for sub in ast.walk(a):
                if isinstance(sub, ast.Subscript) and \
                        _is_relationish(sub.value) and \
                        not isinstance(sub.slice, (ast.Slice, ast.Tuple)):
                    self._emit(
                        "REPRO005", call,
                        f"{q}({_qualname(sub.value)}[...]) materialises "
                        "a whole column — gather candidate rows via "
                        "gather_rows()/chunks()")
                    return

    def _check_full_slice(self, node: ast.Subscript) -> None:
        # table['col'][:] — full-column slice of a relation column
        if not (isinstance(node.slice, ast.Slice)
                and node.slice.lower is None and node.slice.upper is None
                and node.slice.step is None):
            return
        base = node.value
        if isinstance(base, ast.Subscript) and _is_relationish(base.value):
            self._emit("REPRO005", node,
                       "full [:] slice of a Relation column — use "
                       "gather_rows()/chunks()")

    # REPRO007 ---------------------------------------------------------
    def _check_cache_write_swallow(self, node: ast.Try) -> None:
        def broad(h: ast.ExceptHandler) -> bool:
            ty = h.type
            if ty is None:
                return True

            def b(t: ast.AST) -> bool:
                return _qualname(t).split(".")[-1] in ("Exception",
                                                       "BaseException")
            return b(ty) or (isinstance(ty, ast.Tuple)
                             and any(b(e) for e in ty.elts))

        def cache_writes(stmts):
            for stmt in stmts:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call) and \
                            isinstance(sub.func, ast.Attribute) and \
                            sub.func.attr in _CACHE_WRITE_METHODS and \
                            "cache" in _qualname(sub.func.value).lower():
                        yield sub

        if any(broad(h) for h in node.handlers):
            for call in cache_writes(node.body):
                self._emit(
                    "REPRO007", call,
                    f"{_qualname(call.func.value)}.{call.func.attr}() in "
                    "a try whose broad handler can swallow its failure — "
                    "populate caches only at guard-contract sites")
        for h in node.handlers:
            for call in cache_writes(h.body):
                self._emit(
                    "REPRO007", call,
                    f"{_qualname(call.func.value)}.{call.func.attr}() "
                    "inside an except body — a failure path must never "
                    "populate the cache")

    # REPRO006 ---------------------------------------------------------
    def _check_unbudgeted_loop(self, node: ast.AST) -> None:
        header = node.iter if isinstance(node, ast.For) else node.test
        tokens = {n.id for n in ast.walk(header)
                  if isinstance(n, ast.Name)}
        tokens |= {n.attr for n in ast.walk(header)
                   if isinstance(n, ast.Attribute)}
        if not tokens & set(_BUDGET_TOKENS):
            return
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and "budget" in sub.id.lower():
                return
            if isinstance(sub, ast.Attribute) and \
                    "budget" in sub.attr.lower():
                return
        self._emit("REPRO006", node,
                   "loop bounded by max_iters/pivots/nodes never "
                   "consults a SolveBudget — silent truncation "
                   "(the ITER_LIMIT class)")


# ------------------------------------------------------------- entry points


def lint_source(src: str, path: str = "<memory>") -> List[Violation]:
    """Lint one source string (the unit-test entry point)."""
    try:
        return Linter(src, path).run()
    except SyntaxError as e:
        return [Violation("REPRO000", path, e.lineno or 0,
                          f"syntax error: {e.msg}")]


def lint_file(path: str, root: str = ".") -> List[Violation]:
    with open(path) as f:
        src = f.read()
    return lint_source(src, os.path.relpath(path, root))


DEFAULT_LINT_DIRS = ("src/repro_torch", "chip_smoke.py")


def python_files(paths: Sequence[str], root: str = ".") -> List[str]:
    """Every ``*.py`` under ``paths`` (files or directories), sorted."""
    files: List[str] = []
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(full):
            files.append(full)
        else:
            for dirpath, _, names in os.walk(full):
                files.extend(os.path.join(dirpath, n)
                             for n in sorted(names) if n.endswith(".py"))
    return sorted(files)


def lint_paths(paths: Sequence[str], root: str = "."
               ) -> Tuple[List[Violation], int]:
    """Lint every ``*.py`` under ``paths`` (files or directories).
    Returns (violations, files_linted)."""
    files = python_files(paths, root)
    out: List[Violation] = []
    for f in files:
        out.extend(lint_file(f, root))
    return out, len(files)
