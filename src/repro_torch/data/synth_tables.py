"""Synthetic stand-ins for the paper's datasets (SDSS APOGEE-2, TPC-H
LINEITEM sf300), generated to match the column statistics published in
Tables 1-2 so the hardness-derived bounds transfer.

No network access in-container: column marginals are matched (mean/std and
qualitative shape — heavy-tailed tmass_prox/discount/tax, uniform quantity),
which is what the hardness machinery and all benchmarks consume.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def sdss_table(n: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    # tmass_prox: nonnegative, heavy-tailed, mu=14.45 sigma=14.96, many zeros
    raw = rng.gamma(shape=0.55, scale=30.0, size=n)
    raw[rng.random(n) < 0.12] = 0.0
    t = raw * (14.96 / raw.std())
    t = t - t.mean() + 14.45
    t = np.clip(t, 0.0, None)
    return {
        "tmass_prox": t,
        "j": rng.normal(14.82, 1.562, n),
        "h": rng.normal(14.05, 1.657, n),
        "k": rng.normal(13.73, 1.727, n),
    }


def tpch_table(n: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    quantity = rng.integers(1, 51, n).astype(np.float64)   # mu 25.5 sd 14.43
    price = rng.lognormal(mean=0.0, sigma=0.55, size=n)
    price = price * (23290 / price.std())
    price = np.clip(price - price.mean() + 38240, 900.0, None)
    def skewed(mu, sigma):
        v = rng.exponential(scale=1.0, size=n)
        v = v * (sigma / v.std())
        return np.clip(v - v.mean() + mu, 0.0, None)
    return {
        "quantity": quantity,
        "price": price,
        "discount": skewed(1912, 1833),
        "tax": skewed(1530, 1485),
    }


def make_table(kind: str, n: int, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    if kind == "sdss":
        return sdss_table(n, rng)
    if kind == "tpch":
        return tpch_table(n, rng)
    raise ValueError(kind)


def subsample(table: Dict[str, np.ndarray], size: int,
              rng: np.random.Generator) -> Dict[str, np.ndarray]:
    n = len(next(iter(table.values())))
    idx = rng.choice(n, size=min(size, n), replace=False)
    return {k: v[idx] for k, v in table.items()}
