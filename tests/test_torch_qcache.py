"""The port's cross-query cache (``repro_torch.core.qcache``) and its engine
wiring, held to the reference's 14 cases (``tests/test_qcache.py``).

Each case runs the reference engine and the port's (``device="cpu"``)
side by side on the same ``make_table("tpch", 12_000, seed=1)`` with
``d_f=20`` and ``alpha=800``, and asks of the port what the reference
case asks of the reference, and more: the same hit kinds and status
strings, identical packages (idx, mult) and objectives, equal
``CacheStats`` counters and report counters, and the same groups removed
by an append.  Both hierarchies are built once; every case takes a deep
copy of a partitioned engine (hierarchy and rng state included), which is
what the reference case's fresh ``partition()`` gives.
"""
import copy
import dataclasses
import re
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core.shading as ref_shading
from repro.core import hardness as ref_hardness
from repro.core import paql as ref_paql
from repro.core.distributed import BoundedStepCache as RefStepCache
from repro.core.distributed import STEP_CACHE_MAXSIZE as REF_STEP_MAXSIZE
from repro.core.engine import PackageQueryEngine as RefEngine
from repro.core.qcache import QCache as RefQCache
import repro_torch.core.shading as port_shading
from repro_torch.core import hardness, paql
from repro_torch.core.distributed import STEP_CACHE_MAXSIZE, BoundedStepCache
from repro_torch.core.engine import PackageQueryEngine
from repro_torch.core.qcache import QCache
from repro_torch.data.synth_tables import make_table

ATTRS = ["price", "quantity", "discount", "tax"]
ILP_KW = dict(max_nodes=200, time_limit_s=15)
N = 12_000
D_F = 20
ALPHA = 800


@pytest.fixture(scope="module")
def sides():
    """{"ref": ..., "port": ...}: a partitioned engine (no cache), the
    module's QCache class, query makers and the shading module."""
    table = make_table("tpch", N, seed=1)
    out = {}
    for name, Engine, Cache, hd, sh, kw in (
            ("ref", RefEngine, RefQCache, ref_hardness, ref_shading, {}),
            ("port", PackageQueryEngine, QCache, hardness, port_shading,
             {"device": "cpu"})):
        stats = hd.column_stats(table, ATTRS)
        eng = Engine(table, ATTRS, d_f=D_F, alpha=ALPHA, seed=0, **kw)
        out[name] = SimpleNamespace(
            name=name, base=eng.partition(), Cache=Cache, shading=sh,
            Engine=Engine, kw=kw, table=table,
            q2=lambda h, hd=hd, s=stats: hd.instantiate(hd.Q2_TPCH, s, h),
            q4=lambda h, hd=hd, s=stats: hd.instantiate(hd.Q4_TPCH, s, h))
    return out


def _engine(side, cache=None):
    """A fresh copy of the side's partitioned engine with ``cache``."""
    eng = copy.deepcopy(side.base)
    eng.cache = cache
    return eng


def _pkg(res):
    order = np.argsort(res.idx, kind="stable")
    return np.asarray(res.idx)[order], np.asarray(res.mult)[order]


def _same_package(a, b):
    ia, ma = _pkg(a)
    ib, mb = _pkg(b)
    return np.array_equal(ia, ib) and np.array_equal(ma, mb)


def _record(res):
    """What a solve must give on both sides: status without its wall,
    package, objective, bound and the report's cache counters."""
    idx, mult = _pkg(res)
    rep = res.report
    return dict(feasible=res.feasible,
                status=re.sub(r" t=\S+", "", res.status),
                idx=idx.tolist(), mult=mult.tolist(), obj=res.obj,
                lp_obj=res.lp_obj, hits=rep.cache_hits,
                misses=rep.cache_misses, pruned=rep.cache_pruned_lps,
                fallbacks=list(rep.fallbacks),
                cache=getattr(res.ps_stats, "cache", None))


def _both(sides, case):
    """Run ``case(side)`` on each side; the port's record must equal the
    reference's.  Returns (reference's, port's)."""
    got = {name: case(side) for name, side in sides.items()}
    assert got["port"] == got["ref"]
    return got["ref"], got["port"]


# ------------------------------------------------------------ signatures


def test_signature_reorder_identity():
    for mod in (ref_paql, paql):
        cts = (mod.Constraint(None, 2, 10), mod.Constraint("price", 5.0, 50.0),
               mod.Constraint("tax", 0.0, 1.0, avg_target=0.5))
        q1 = mod.PackageQuery("price", True, cts)
        q2 = mod.PackageQuery("price", True, cts[::-1])
        assert q1.signature() == q2.signature()
        assert q1.signature().digest() == q2.signature().digest()


def test_signature_containment(sides):
    rows = []
    for side in sides.values():
        prime, tight = side.q2(2.0).signature(), side.q2(3.0).signature()
        wide, disjoint = side.q2(1.0).signature(), side.q4(2.0).signature()
        rows.append([tight.contained_in(prime), tight.contained_in(tight),
                     prime.contained_in(tight), wide.contained_in(prime),
                     disjoint.contained_in(prime),
                     prime.contained_in(disjoint),
                     prime.digest(), tight.digest()])
    assert rows[0] == rows[1]
    assert rows[1][:6] == [True, True, False, False, False, False]


def test_signature_digest_process_stable():
    digests = []
    for mod in (ref_paql, paql):
        q = mod.PackageQuery("price", True, (mod.Constraint(None, 2, 10),))
        d = q.signature().digest()
        assert d == q.signature().digest()
        assert len(d) == 40                     # sha1 hex, not hash()
        q2 = mod.PackageQuery("price", True, (mod.Constraint(None, 2, 11),))
        assert q2.signature().digest() != d
        digests.append(d)
    assert digests[0] == digests[1]


# ------------------------------------------------------- hit/parity paths


def test_exact_hit_package_parity_and_counters(sides):
    def case(side):
        q = side.q2(2.0)
        cache = side.Cache()
        eng = _engine(side, cache)
        r1 = eng.solve(q, ilp_kwargs=ILP_KW)
        r2 = eng.solve(q, ilp_kwargs=ILP_KW)
        assert r1.feasible and r2.feasible
        assert "cached=package" in r2.status
        assert _same_package(r1, r2) and r1.obj == r2.obj
        assert cache.stats.exact_hits == 1 and cache.stats.misses == 1
        assert cache.stats.stores == 1 and cache.stats.bytes > 0
        assert r2.report.cache_hits == 1 and r2.report.cache_pruned_lps > 0
        assert r1.report.cache_misses == 1
        assert "cache=" in r2.report.summary()
        assert r2.ps_stats is not None and r2.ps_stats.cache == "package"
        return [_record(r1), _record(r2), cache.stats.as_dict()]

    _both(sides, case)


def test_artifact_only_mode_parity(sides):
    def case(side):
        q = side.q2(2.0)
        cache = side.Cache(reuse_packages=False)
        eng = _engine(side, cache)
        r1 = eng.solve(q, ilp_kwargs=ILP_KW)
        r2 = eng.solve(q, ilp_kwargs=ILP_KW)
        assert "cached=exact" in r2.status     # re-solved, not replayed
        assert _same_package(r1, r2)
        assert r2.report.cache_pruned_lps > 0
        return [_record(r1), _record(r2), cache.stats.as_dict()]

    _both(sides, case)


def test_contained_hit_prune_accepted(sides):
    def case(side):
        cache = side.Cache(gap_accept=2.0)     # lenient: prune accepted
        eng = _engine(side, cache)
        q_prime, q_tight = side.q2(2.0), side.q2(3.0)
        r0 = eng.solve(q_prime, ilp_kwargs=ILP_KW)
        assert r0.feasible
        r1 = eng.solve(q_tight, ilp_kwargs=ILP_KW)
        assert r1.feasible
        assert "cached=contained" in r1.status
        assert cache.stats.contained_hits == 1
        assert q_tight.check_package(side.table, r1.idx, r1.mult)
        assert r1.lp_obj <= r0.lp_obj + 1e-6 * max(1.0, abs(r0.lp_obj))
        return [_record(r0), _record(r1), cache.stats.as_dict()]

    _both(sides, case)


def test_gap_rejected_prune_falls_back_with_parity(sides):
    def case(side):
        cache = side.Cache(gap_accept=-1.0)    # reject every prune
        eng = _engine(side, cache)
        q_prime, q_tight = side.q2(2.0), side.q2(3.0)
        eng.solve(q_prime, ilp_kwargs=ILP_KW)
        r1 = eng.solve(q_tight, ilp_kwargs=ILP_KW)
        r_cold = _engine(side).solve(q_tight, ilp_kwargs=ILP_KW)
        assert "cached" not in r1.status
        assert "cache_fallback" in r1.report.fallbacks
        assert cache.stats.fallbacks == 1
        assert _same_package(r1, r_cold) and r1.obj == r_cold.obj
        r2 = eng.solve(q_tight, ilp_kwargs=ILP_KW)
        assert "cached=package" in r2.status and _same_package(r1, r2)
        return [_record(r1), _record(r_cold), _record(r2),
                cache.stats.as_dict()]

    _both(sides, case)


def test_poisoned_entry_falls_back_with_parity(sides):
    def case(side):
        q = side.q2(2.0)
        cache = side.Cache()
        eng = _engine(side, cache)
        r1 = eng.solve(q, ilp_kwargs=ILP_KW)
        (_, _, entry), = cache.entries()
        entry.package_obj += 1e9               # poison: validation fails
        entry.lp_bound += 1e9
        r2 = eng.solve(q, ilp_kwargs=ILP_KW)
        assert "cached" not in r2.status
        assert "cache_fallback" in r2.report.fallbacks
        assert _same_package(r1, r2) and r1.obj == r2.obj
        return [_record(r1), _record(r2), cache.stats.as_dict()]

    _both(sides, case)


# ------------------------------------------------ invalidation + appends


def test_append_invalidates_exactly_touched_ancestry(sides):
    def case(side):
        q = side.q2(2.0)
        cache = side.Cache()
        eng = _engine(side, cache)
        r0 = eng.solve(q, ilp_kwargs=ILP_KW)
        assert r0.feasible
        (_, _, entry), = cache.entries()
        hier = eng.hierarchy
        before = {l: set(entry.group_ids(l)) for l in range(1, hier.L + 1)}
        assert entry.complete and all(before[l] for l in before)

        # package-colocated rows guarantee at least one cached leaf is hit
        rows = {a: np.asarray(side.table[a][r0.idx[:7]], np.float64)
                for a in ATTRS}
        rep = hier.append(rows)
        touched = np.unique(rep.gids)
        ancestors = hier.leaf_ancestors(touched)
        assert np.array_equal(ancestors[1], touched)

        assert not entry.complete
        removed = {}
        for l in range(1, hier.L + 1):
            removed[l] = sorted(before[l] - set(entry.group_ids(l)))
            expected = before[l] & set(int(g) for g in ancestors[l])
            assert set(removed[l]) == expected, (l, removed[l], expected)
            if removed[l]:
                assert entry.candidates(l) is None
        total = sum(len(v) for v in removed.values())
        assert cache.stats.invalidated_groups == total > 0

        # an incomplete entry never serves hits again: stale miss
        misses0, stale0 = cache.stats.misses, cache.stats.stale_misses
        assert cache.lookup(hier.fingerprint, q.signature()) is None
        assert cache.stats.stale_misses == stale0 + 1
        assert cache.stats.misses == misses0 + 1
        return [_record(r0), rep.gids.tolist(), rep.flagged.tolist(),
                rep.tv_bar, removed,
                {l: a.tolist() for l, a in ancestors.items()},
                cache.stats.as_dict()]

    _both(sides, case)


def test_cached_vs_cold_parity_after_append(sides):
    def case(side):
        q = side.q2(2.0)
        cache = side.Cache()
        eng = _engine(side, cache)
        r0 = eng.solve(q, ilp_kwargs=ILP_KW)
        assert r0.feasible
        eng.hierarchy.append({a: np.asarray(side.table[a][r0.idx[:3]],
                                            np.float64) for a in ATTRS})
        (_, _, entry), = cache.entries()
        assert not entry.complete
        r1 = eng.solve(q, ilp_kwargs=ILP_KW)   # stale -> cold, re-store
        r_cold = _engine(side).solve(q, ilp_kwargs=ILP_KW)
        assert "cached" not in r1.status
        assert _same_package(r1, r_cold) and r1.obj == r_cold.obj
        r2 = eng.solve(q, ilp_kwargs=ILP_KW)   # re-populated entry hits
        assert "cached=package" in r2.status and _same_package(r1, r2)
        return [_record(r) for r in (r0, r1, r_cold, r2)] + \
            [cache.stats.as_dict()]

    _both(sides, case)


def test_fingerprint_stable_across_rebuilds(sides):
    def case(side):
        def build(d_f):
            return side.Engine(side.table, ATTRS, d_f=d_f, alpha=ALPHA,
                               seed=0, **side.kw).partition().hierarchy
        h1, h2 = side.base.hierarchy.fingerprint, build(D_F).fingerprint
        assert h1 == h2
        h3 = build(D_F + 5).fingerprint
        assert h3 != h1
        return [h1, h3]

    _both(sides, case)


# ----------------------------------------------------- eviction + bounds


def test_lru_eviction_by_bytes(sides):
    def case(side):
        cache = side.Cache(max_bytes=1)        # everything over budget
        eng = _engine(side, cache)
        q_a, q_b = side.q2(2.0), side.q4(1.0)  # disjoint: its own entry
        ra = eng.solve(q_a, ilp_kwargs=ILP_KW)
        assert ra.feasible and len(cache) == 1  # sole entry survives
        rb = eng.solve(q_b, ilp_kwargs=ILP_KW)
        assert rb.feasible
        assert len(cache) == 1 and cache.stats.evictions == 1
        hits0 = cache.stats.hits                # q_a was evicted: a miss
        r = eng.solve(q_a, ilp_kwargs=ILP_KW)
        assert r.feasible and "cached" not in r.status
        assert cache.stats.hits == hits0
        assert cache.stats.bytes <= max(e.nbytes for _, _, e
                                        in cache.entries()) + 1
        return [_record(x) for x in (ra, rb, r)] + [cache.stats.as_dict()]

    _both(sides, case)


# -------------------------------------------------- warm-start telemetry


def test_warm_rejected_surfaced(sides, monkeypatch):
    for side in sides.values():                 # every re-map rejects
        monkeypatch.setattr(side.shading, "fill_warm_basis",
                            lambda *a, **k: None)

    def case(side):
        res = _engine(side).solve(side.q2(2.0), ilp_kwargs=ILP_KW)
        assert res.feasible
        assert res.ps_stats.warm_rejected > 0
        assert res.report.warm_rejected > 0
        assert "warm_rejected" in res.report.summary()
        assert any("warm_map_rejected" in n for n in res.report.notes)
        return [_record(res), res.ps_stats.warm_rejected,
                res.report.warm_rejected,
                [n for n in res.report.notes if "warm_map" in n]]

    _both(sides, case)


# ------------------------------------------------ distributed step cache


def test_bounded_step_cache_counters():
    """The port's step cache counts as the reference's over the same key
    sequence (``core.distributed`` keeps its step triples in one, as the
    batched LP engine keeps its workspaces)."""
    stats = []
    for Cache in (RefStepCache, BoundedStepCache):
        c = Cache(maxsize=2)
        made = []
        for key in ("a", "b", "a", "c", "b"):  # LRU 'b' evicted by 'c'
            c.get_or_create(key, lambda k=key: made.append(k) or k.upper())
        assert made == ["a", "b", "c", "b"]
        assert c.hits == 1 and c.misses == 4 and c.evictions == 2
        assert len(c) == 2
        assert c.hits + c.misses == c.lookups
        stats.append(c.stats())
        c.clear()
        assert len(c) == 0
    assert stats[0] == stats[1] == {"hits": 1, "misses": 4, "evictions": 2,
                                    "lookups": 5, "size": 2, "maxsize": 2}
    assert STEP_CACHE_MAXSIZE == REF_STEP_MAXSIZE == 64


def test_cache_stats_fields_match_reference():
    from repro.core.qcache import CacheStats as RefStats
    from repro_torch.core.qcache import CacheStats
    assert [f.name for f in dataclasses.fields(CacheStats)] == \
        [f.name for f in dataclasses.fields(RefStats)]
    assert QCache.__guarded_by__ == RefQCache.__guarded_by__
