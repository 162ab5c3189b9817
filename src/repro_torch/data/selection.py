"""Package-query-driven training-data selection (port of
``repro.data.selection``) -- the paper's technique as a feature of the
trainer.

The training corpus is a relation: one row per document with columns
(quality score, token count, per-domain indicators, dedup-cluster cost).
Curating a training mix IS a package query:

    SELECT PACKAGE(*) FROM corpus REPEAT 0
    SUCH THAT  SUM(tokens)        BETWEEN budget*(1-slack) AND budget
           AND SUM(domain_web)    <= web_cap_tokens   (per-domain mix caps)
           AND SUM(dup_penalty)   <= dup_budget
    MAXIMIZE   SUM(quality)

The corpus is made by numpy as the reference makes it (the same table for
the same spec); the query runs through the port's engine on ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core.dual_reducer import PackageResult
from repro_torch.core.engine import PackageQueryEngine
from repro_torch.core.lp_kernel import solve_lp_kernel
from repro_torch.core.paql import Constraint, PackageQuery


@dataclasses.dataclass
class CorpusSpec:
    num_docs: int
    domains: Sequence[str] = ("web", "code", "papers", "books")
    seed: int = 0


def synth_corpus(spec: CorpusSpec) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(spec.seed)
    n = spec.num_docs
    table: Dict[str, np.ndarray] = {
        "quality": np.clip(rng.normal(0.55, 0.2, n), 0, 1),
        "tokens": rng.lognormal(7.2, 1.0, n).clip(64, 65536).round(),
        "dup_penalty": rng.exponential(0.1, n),
    }
    dom = rng.integers(0, len(spec.domains), n)
    for i, d in enumerate(spec.domains):
        table[f"dom_{d}"] = (dom == i).astype(np.float64)
        # token-weighted domain usage
        table[f"tok_{d}"] = table[f"dom_{d}"] * table["tokens"]
    # quality correlates with papers/books a bit
    table["quality"] += 0.08 * (table["dom_papers"] + table["dom_books"])
    return table


def selection_query(table: Dict[str, np.ndarray], *, token_budget: float,
                    domain_caps: Optional[Dict[str, float]] = None,
                    dup_budget: Optional[float] = None,
                    slack: float = 0.05) -> PackageQuery:
    cons = [Constraint("tokens", lo=token_budget * (1 - slack),
                       hi=token_budget)]
    for d, cap in (domain_caps or {}).items():
        cons.append(Constraint(f"tok_{d}", hi=cap))
    if dup_budget is not None:
        cons.append(Constraint("dup_penalty", hi=dup_budget))
    return PackageQuery("quality", maximize=True, constraints=tuple(cons))


def select_training_docs(table: Dict[str, np.ndarray],
                         query: PackageQuery, *, d_f: int = 50,
                         alpha: int = 5000, seed: int = 0,
                         device="cuda") -> PackageResult:
    """The selected package: the engine's hierarchy built and the query
    solved on ``device`` (default ``"cuda"``; raises without CUDA unless
    ``device="cpu"``), the layer LPs through the device twin
    ``solve_lp_kernel`` (on the card its pricing and BFRT kernels; on the
    CPU their plain versions)."""
    attrs = [query.objective_attr] + [
        c.attr for c in query.constraints if c.attr]
    eng = PackageQueryEngine(table, attrs, d_f=d_f, alpha=alpha, seed=seed,
                             device=device)
    eng.partition()
    return eng.solve(query, ilp_kwargs=dict(max_nodes=200, time_limit_s=30),
                     lp_solver=solve_lp_kernel)
