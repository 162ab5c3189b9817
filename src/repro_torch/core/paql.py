"""PaQL-style package queries and their ILP/LP standard forms.

A package query over a relation R (columns = named float arrays, OR a
:class:`repro_torch.core.relation.Relation` for out-of-core tables):

    SELECT PACKAGE(*) FROM R REPEAT r
    WHERE <local predicate mask>
    SUCH THAT
        cl <= COUNT(P.*) <= cu
        SUM(P.attr) {<=,>=,BETWEEN} b ...
        AVG(P.attr) {<=,>=} t ...
    {MAXIMIZE|MINIMIZE} SUM(P.obj)

maps to the ILP  opt cᵀx  s.t.  bl <= Ax <= bu,  0 <= x <= r+1,  x ∈ ℤ.

AVG(P.a) >= t is linearised as SUM(P.a) - t*COUNT(P) >= 0, i.e. a row with
coefficients (a_i - t).

Out-of-core path: ``matrices(rel, subset)`` builds the candidate-resident
standard form from ONE ``gather_rows`` over the query's attributes — the
whole pipeline (shading layers, Dual Reducer, validation) passes tuple-id
subsets around and only ever materialises O(|subset|) rows.  With
``subset=None`` over a streamed relation the (m, n) assembly is filled
chunk-wise (each constraint row is a plain column gather) behind a size
guard, since a dense full-relation form at 10^9 tuples is exactly what the
paper's architecture avoids.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

INF = float("inf")

# Dense full-relation (c, A, ub) assembly guard for streamed relations:
# raise above this many bytes instead of silently materialising.
FULL_MATRIX_BUDGET_BYTES = 4 << 30


@dataclasses.dataclass(frozen=True)
class Constraint:
    """bl <= SUM(coeff_expr) <= bu over the package."""
    attr: Optional[str]          # None => COUNT (coefficients 1)
    lo: float = -INF
    hi: float = INF
    avg_target: Optional[float] = None  # AVG constraint: coeff = attr - target

    def coeffs(self, table: Dict[str, np.ndarray], n: int) -> np.ndarray:
        if self.attr is None:
            return np.ones(n)
        col = np.asarray(table[self.attr], dtype=np.float64)
        if self.avg_target is not None:
            return col - self.avg_target
        return col


def _is_streamed(table) -> bool:
    from repro_torch.core.relation import Relation
    return isinstance(table, Relation) and not table.in_memory


def _gather_view(table, names: Sequence[str],
                 idx: np.ndarray) -> Dict[str, np.ndarray]:
    """The rows ``idx`` of the named columns, for a dict or a Relation."""
    from repro_torch.core.relation import Relation
    if isinstance(table, Relation):
        return table.gather_rows(idx, tuple(names))
    return {nm: np.asarray(table[nm], np.float64)[idx] for nm in names}


@dataclasses.dataclass(frozen=True)
class QuerySignature:
    """Canonical, hashable identity of a package query's constraint
    region (the cross-query cache key of the reference's ``core.qcache``,
    not ported yet).

    Constraint order is normalized away (sorted by constraint identity),
    bounds are canonical floats, and equality/hash follow from the
    frozen-dataclass field tuple.  ``keys`` holds one ``(attr,
    avg_target)`` identity per constraint ('' = COUNT, None = plain
    SUM); ``los``/``his`` the matching interval endpoints.
    """
    objective_attr: str
    maximize: bool
    repeat: int
    predicate_attr: Optional[str]
    keys: Tuple[Tuple[str, Optional[float]], ...]
    los: Tuple[float, ...]
    his: Tuple[float, ...]

    def same_structure(self, other: "QuerySignature") -> bool:
        """Identical up to the constraint intervals: same objective and
        sense, same repeat/predicate, same constraint identities."""
        return (self.objective_attr == other.objective_attr
                and self.maximize == other.maximize
                and self.repeat == other.repeat
                and self.predicate_attr == other.predicate_attr
                and self.keys == other.keys)

    def contained_in(self, other: "QuerySignature") -> bool:
        """True when this query's constraint region is contained in
        ``other``'s: same structure and every interval nested.  Sound
        for the cache's subsumption path — any package feasible for
        ``self`` is feasible for ``other``, so ``other``'s candidate
        sets cover at least the region ``self`` can draw from."""
        if not self.same_structure(other):
            return False
        return all(lo >= olo and hi <= ohi
                   for lo, olo, hi, ohi in zip(self.los, other.los,
                                               self.his, other.his))

    def digest(self) -> str:
        """Process-stable hex digest (string ``hash()`` is salted per
        process; persisted/shared caches need this instead)."""
        payload = repr((self.objective_attr, self.maximize, self.repeat,
                        self.predicate_attr, self.keys, self.los,
                        self.his))
        return hashlib.sha1(payload.encode()).hexdigest()


@dataclasses.dataclass(frozen=True)
class PackageQuery:
    objective_attr: str
    maximize: bool
    constraints: Tuple[Constraint, ...]
    repeat: int = 0              # each tuple usable up to repeat+1 times
    predicate_attr: Optional[str] = None   # local predicate: column of {0,1}

    @property
    def m(self) -> int:
        return len(self.constraints)

    def needed_attrs(self, table=None) -> List[str]:
        """Columns this query touches (objective, constraints, predicate —
        the predicate only where the table actually carries it)."""
        names = [self.objective_attr]
        for ct in self.constraints:
            if ct.attr is not None and ct.attr not in names:
                names.append(ct.attr)
        if self.predicate_attr is not None and \
                self.predicate_attr not in names and \
                (table is None or self.predicate_attr in table):
            names.append(self.predicate_attr)
        return names

    def signature(self) -> QuerySignature:
        """Canonical :class:`QuerySignature` for cross-query caching.

        Reordered-but-identical constraint lists produce identical
        signatures; tightening any interval produces a signature
        ``contained_in`` the original's.
        """
        rows = sorted(
            ((ct.attr or "",
              None if ct.avg_target is None else float(ct.avg_target),
              float(ct.lo), float(ct.hi))
             for ct in self.constraints),
            key=lambda r: (r[0], -INF if r[1] is None else r[1],
                           r[2], r[3]))
        return QuerySignature(
            objective_attr=self.objective_attr,
            maximize=bool(self.maximize),
            repeat=int(self.repeat),
            predicate_attr=self.predicate_attr,
            keys=tuple((a, t) for a, t, _, _ in rows),
            los=tuple(lo for _, _, lo, _ in rows),
            his=tuple(hi for _, _, _, hi in rows))

    # ------------------------------------------------------------------
    def _assemble(self, view: Dict[str, np.ndarray], n: int):
        c = np.asarray(view[self.objective_attr], np.float64).copy()
        if self.maximize:
            c = -c
        A = np.stack([ct.coeffs(view, n) for ct in self.constraints]) \
            if self.constraints else np.zeros((0, n))
        ub = np.full(n, self.repeat + 1, np.float64)
        # Local predicates (Appendix E): applied where the column exists —
        # layer-0 tables carry it (final ILP forces ub=0 on excluded
        # tuples); representative layers don't (predicates are ignored
        # until the final layer, the paper's "efficient approach").
        if self.predicate_attr is not None and self.predicate_attr in view:
            ub = ub * np.asarray(view[self.predicate_attr], np.float64)
        return c, A, ub

    def matrices(self, table, subset: Optional[np.ndarray] = None):
        """Dense (c, A, bl, bu, ub) for the tuples in ``subset`` (or all).

        Returns the MINIMIZATION form: internal c is negated for MAXIMIZE.
        ``table`` may be a dict of arrays or any Relation; only the
        query's own attributes are ever gathered.
        """
        bl = np.array([ct.lo for ct in self.constraints], np.float64)
        bu = np.array([ct.hi for ct in self.constraints], np.float64)
        names = self.needed_attrs(table)
        if subset is not None:
            idx = np.asarray(subset)
            view = _gather_view(table, names, idx)
            c, A, ub = self._assemble(view, len(idx))
            return c, A, bl, bu, ub
        if not _is_streamed(table):
            # dict of arrays, or an in-memory Relation (columns resident)
            # repro: allow[REPRO005] guarded by _is_streamed above
            view = {nm: np.asarray(table[nm], np.float64) for nm in names}
            n = len(view[self.objective_attr])
            c, A, ub = self._assemble(view, n)
            return c, A, bl, bu, ub
        # streamed full-relation assembly: chunk-wise column gathers
        n = table.num_rows
        need = (self.m + 2) * n * 8
        if need > FULL_MATRIX_BUDGET_BYTES:
            raise ValueError(
                f"full-relation matrix assembly over {n} streamed rows "
                f"needs ~{need / 1e9:.1f} GB (> "
                f"{FULL_MATRIX_BUDGET_BYTES / 1e9:.1f} GB budget); use the "
                "hierarchical solver (engine.solve) for out-of-core "
                "relations, or raise repro_torch.core.paql."
                "FULL_MATRIX_BUDGET_BYTES explicitly")
        c = np.empty(n, np.float64)
        A = np.empty((self.m, n), np.float64)
        ub = np.empty(n, np.float64)
        a = 0
        for block in table.chunks(tuple(names)):
            b = a + len(block)
            view = {nm: block[:, j] for j, nm in enumerate(names)}
            cc, Ac, uc = self._assemble(view, b - a)
            c[a:b] = cc
            A[:, a:b] = Ac
            ub[a:b] = uc
            a = b
        return c, A, bl, bu, ub

    def objective_value(self, table, idx: np.ndarray,
                        mult: np.ndarray) -> float:
        col = _gather_view(table, (self.objective_attr,),
                           np.asarray(idx))[self.objective_attr]
        return float(np.dot(col, mult))

    def check_package(self, table, idx: np.ndarray,
                      mult: np.ndarray, tol: float = 1e-6) -> bool:
        """Validate the package against the relation — one gather of the
        package's own rows (streamed columns for out-of-core tables)."""
        idx = np.asarray(idx)
        names = [ct.attr for ct in self.constraints if ct.attr is not None]
        view = _gather_view(table, list(dict.fromkeys(names)), idx) \
            if names else {}
        for ct in self.constraints:
            coeff = ct.coeffs(view, len(idx))
            val = float(np.dot(coeff, mult))
            if val < ct.lo - tol or val > ct.hi + tol:
                return False
        return True
