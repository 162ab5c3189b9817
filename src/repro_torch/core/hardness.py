"""Query-hardness benchmark — paper §4.1 (+ Tables 1 and 2).

Hardness h̃ := -log10 Π P(C_i); bounds are derived by inverting the CLT
normal CDF so every constraint satisfies P(C_i) = 10^(-h̃/m) for a random
package of the expected size E.  Verified to reproduce the paper's Table 1
bounds (e.g. Q1 SDSS h̃=1: b1=445.37, b2=420.68, b3=406.04, b4=417.76).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.paql import Constraint, PackageQuery

SQRT2 = math.sqrt(2.0)


def ndtri(p: float) -> float:
    """Inverse standard normal CDF (Acklam's rational approximation +
    one Halley refinement; |error| < 1e-12 — no scipy in-container)."""
    if not 0.0 < p < 1.0:
        raise ValueError(p)
    a = [-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        ql = math.sqrt(-2 * math.log(p))
        x = (((((c[0] * ql + c[1]) * ql + c[2]) * ql + c[3]) * ql + c[4]) * ql
             + c[5]) / ((((d[0] * ql + d[1]) * ql + d[2]) * ql + d[3]) * ql + 1)
    elif p <= phigh:
        ql = p - 0.5
        r = ql * ql
        x = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r
             + a[5]) * ql / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r
                              + b[4]) * r + 1)
    else:
        ql = math.sqrt(-2 * math.log(1 - p))
        x = -(((((c[0] * ql + c[1]) * ql + c[2]) * ql + c[3]) * ql + c[4]) * ql
              + c[5]) / ((((d[0] * ql + d[1]) * ql + d[2]) * ql + d[3]) * ql + 1)
    # one step of Halley's method on Phi(x) - p
    e = 0.5 * math.erfc(-x / SQRT2) - p
    u = e * math.sqrt(2 * math.pi) * math.exp(x * x / 2)
    return x - u / (1 + x * u / 2)


@dataclasses.dataclass(frozen=True)
class BoundSpec:
    attr: str
    kind: str          # 'ge' | 'le' | 'between'


@dataclasses.dataclass(frozen=True)
class QueryTemplate:
    """A package-query template whose bounds are set by hardness level."""
    name: str
    objective_attr: str
    maximize: bool
    count_lo: int
    count_hi: int
    bounds: Tuple[BoundSpec, ...]
    repeat: int = 0

    @property
    def expected_size(self) -> float:
        return 0.5 * (self.count_lo + self.count_hi)


def instantiate(template: QueryTemplate, stats: Dict[str, Tuple[float, float]],
                hardness: float) -> PackageQuery:
    """Set constraint bounds for hardness h̃ per §4.1."""
    E = template.expected_size
    m = len(template.bounds)
    p = 10.0 ** (-hardness / m)
    cons: List[Constraint] = [
        Constraint(None, template.count_lo, template.count_hi)]
    for spec in template.bounds:
        mu, sigma = stats[spec.attr]
        se = math.sqrt(E) * sigma
        if spec.kind == "ge":
            b = E * mu + se * ndtri(1 - p)
            cons.append(Constraint(spec.attr, lo=b))
        elif spec.kind == "le":
            b = E * mu + se * ndtri(p)
            cons.append(Constraint(spec.attr, hi=b))
        elif spec.kind == "between":
            z = ndtri(0.5 * (1 + p))
            cons.append(Constraint(spec.attr, lo=E * mu - z * se,
                                   hi=E * mu + z * se))
        else:
            raise ValueError(spec.kind)
    return PackageQuery(template.objective_attr, template.maximize,
                        tuple(cons), repeat=template.repeat)


def column_stats(table: Dict[str, np.ndarray],
                 attrs: Sequence[str]) -> Dict[str, Tuple[float, float]]:
    return {a: (float(np.mean(table[a])), float(np.std(table[a])))
            for a in attrs}


# ------------------------------------------------- the paper's benchmark

Q1_SDSS = QueryTemplate(
    name="Q1_SDSS", objective_attr="tmass_prox", maximize=False,
    count_lo=15, count_hi=45,
    bounds=(BoundSpec("j", "ge"), BoundSpec("h", "le"),
            BoundSpec("k", "between")))

Q2_TPCH = QueryTemplate(
    name="Q2_TPCH", objective_attr="price", maximize=True,
    count_lo=15, count_hi=45,
    bounds=(BoundSpec("quantity", "ge"), BoundSpec("discount", "le"),
            BoundSpec("tax", "between")))

Q3_SDSS = QueryTemplate(
    name="Q3_SDSS", objective_attr="k", maximize=True,
    count_lo=25, count_hi=75,
    bounds=(BoundSpec("tmass_prox", "ge"), BoundSpec("j", "le"),
            BoundSpec("h", "between")))

Q4_TPCH = QueryTemplate(
    name="Q4_TPCH", objective_attr="tax", maximize=False,
    count_lo=50, count_hi=150,
    bounds=(BoundSpec("quantity", "le"), BoundSpec("price", "between")))

TEMPLATES = {t.name: t for t in (Q1_SDSS, Q2_TPCH, Q3_SDSS, Q4_TPCH)}
