"""The port's lint and concurrency passes (``repro_torch.analysis``)
against the reference's (``repro.analysis``), which import no JAX.

The rules that carry over unchanged (REPRO004, REPRO006-012) give the
same (rule, line) findings as the reference's on the reference's own
snippets (``tests/test_analysis_lint.py``'s ``SNIPPETS``, loaded from
that file), and their suppressions behave the same; REPRO002, 003 and
005 have the port's torch forms and torch snippets; REPRO001 has no
counterpart.  The ratchet, the budget and the ring model equal the
reference's; the port's head is clean against its baseline and carries
no concurrency debt; the CLI fails on every seeded snippet and refuses
to grow a pin.
"""
import ast
import importlib.util
import json
import os

import pytest

from repro.analysis import concurrency as ref_conc
from repro.analysis import lint as ref_lint
from repro.analysis import report as ref_report
from repro.distributed import hlo_analysis
from repro_torch.analysis import collectives, concurrency, lint, report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(ROOT, "src", "repro_torch", "analysis",
                        "baseline.json")


def _reference_snippets():
    spec = importlib.util.spec_from_file_location(
        "_reference_lint_tests", os.path.join(ROOT, "tests",
                                              "test_analysis_lint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SNIPPETS


SNIPPETS = _reference_snippets()
SAME_RULES = ("REPRO004", "REPRO006", "REPRO007", "REPRO008", "REPRO009",
              "REPRO010", "REPRO011", "REPRO012")


def port_scan(src, path="snippet.py"):
    return lint.lint_source(src, path) + concurrency.check_source(src, path)


def ref_scan(src, path="snippet.py"):
    return ref_lint.lint_source(src, path) + ref_conc.check_source(src, path)


def found(vs, rule=None):
    return sorted((v.rule, v.line) for v in vs
                  if rule is None or v.rule == rule)


def with_allows(src, rule, lines, reason="tested escape hatch"):
    out = src.splitlines()
    for ln in sorted(lines, reverse=True):
        indent = out[ln - 1][:len(out[ln - 1]) - len(out[ln - 1].lstrip())]
        out.insert(ln - 1, f"{indent}# repro: allow[{rule}] {reason}")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------- parity


@pytest.mark.parametrize("rule", SAME_RULES)
def test_carried_rule_matches_the_reference(rule):
    src = SNIPPETS[rule]
    want = found(ref_scan(src), rule)
    assert want, f"the reference's {rule} snippet no longer fires"
    assert found(port_scan(src), rule) == want


@pytest.mark.parametrize("rule", SAME_RULES)
def test_carried_rule_suppression_matches_the_reference(rule):
    src = SNIPPETS[rule]
    lines = {ln for _, ln in found(ref_scan(src), rule)}
    # silenced by a reasoned allow on the comment line above
    quiet = with_allows(src, rule, lines)
    assert found(port_scan(quiet), rule) == found(ref_scan(quiet), rule) \
        == []
    # a bare allow is no suppression
    bare = with_allows(src, rule, lines, reason="")
    assert found(port_scan(bare), rule) == found(ref_scan(bare), rule) \
        != []
    # another rule's allow is no suppression
    other = with_allows(src, "REPRO001" if rule != "REPRO001"
                        else "REPRO004", lines)
    assert found(port_scan(other), rule) == found(ref_scan(other), rule) \
        != []


@pytest.mark.parametrize("rule", SAME_RULES)
def test_trailing_allow_on_the_flagged_line(rule):
    src = SNIPPETS[rule].splitlines()
    lines = {ln for _, ln in found(ref_scan(SNIPPETS[rule]), rule)}
    for ln in lines:
        src[ln - 1] += f"  # repro: allow[{rule}] trailing escape hatch"
    src = "\n".join(src) + "\n"
    assert found(port_scan(src), rule) == found(ref_scan(src), rule) == []


def test_syntax_error_reports_repro000_in_both_passes():
    for scan in (lint.lint_source, concurrency.check_source,
                 ref_lint.lint_source, ref_conc.check_source):
        assert [v.rule for v in scan("def f(:\n", "bad.py")] == ["REPRO000"]


def test_reference_repro001_snippet_gives_no_finding():
    assert found(ref_scan(SNIPPETS["REPRO001"]), "REPRO001")
    assert port_scan(SNIPPETS["REPRO001"]) == []
    assert "no counterpart" in lint.RULES["REPRO001"]


def test_rule_sets_line_up():
    assert sorted(lint.RULES) == sorted(ref_lint.RULES)
    assert sorted(concurrency.CONCURRENCY_RULES) == \
        sorted(ref_conc.CONCURRENCY_RULES)
    assert concurrency._STRICT_SUFFIXES == ref_conc._STRICT_SUFFIXES
    assert ref_conc._DISPATCH_CALLEES < concurrency._DISPATCH_CALLEES
    assert {"solve_lp_kernel", "LaneSolver"} <= concurrency._DISPATCH_CALLEES


# ------------------------------------------------------ the torch forms

SOLVER = "src/repro_torch/core/lp.py"
F32_SNIPPETS = {
    "tensor": "import torch\ndef f():\n    return torch.tensor(1.5)\n",
    "full": "import torch\ndef f(n):\n    return torch.full((n,), 0.5)\n",
    "zeros": "import torch\ndef f(n):\n    return torch.zeros(n)\n",
    "float_call": "import torch\ndef f(x):\n"
                  "    return torch.as_tensor(float(x))\n",
}


@pytest.mark.parametrize("name", sorted(F32_SNIPPETS))
def test_repro002_default_float32_factory_in_a_solver_module(name):
    src = F32_SNIPPETS[name]
    assert found(lint.lint_source(src, SOLVER)) == [("REPRO002", 3)]
    # the same call outside the float64 modules, or with dtype=, is fine
    assert lint.lint_source(src, "src/repro_torch/models/layers.py") == []
    typed = src.replace(")\n", ", dtype=torch.float64)\n")
    assert lint.lint_source(typed, SOLVER) == []
    assert lint.lint_source(with_allows(src, "REPRO002", {3}), SOLVER) == []


def test_repro002_beyond_f32_literal_and_the_sanctioned_sentinel():
    src = "def f(x):\n    big = 1e300\n    return x + big\n"
    assert found(lint.lint_source(src, "a.py")) == [("REPRO002", 2)]
    assert found(ref_lint.lint_source(src, "a.py")) == [("REPRO002", 2)]
    sentinel = "def big_sentinel(dtype):\n    return 1e300\n"
    assert lint.lint_source(sentinel, "src/repro_torch/core/distributed.py") \
        == []
    assert found(lint.lint_source(sentinel, "src/repro_torch/core/lp.py")) \
        == [("REPRO002", 2)]
    # the reference's float64-reference half has nothing to guard in torch
    assert lint.lint_source("import torch\nX = torch.float64\n", SOLVER) == []


HOT = '''\
import torch
def read(t):
    return t.cpu()
def _solve(A, max_iters, budget):
    x = A.sum().item()
    it = 0
    while it < budget.cap(max_iters):
        a = A.sum().item()
        b = A.cpu()
        c = A.tolist()
        d = A.numpy()
        e = A.to("cpu")
        f = read(A)
        it += 1
    return A.cpu()
'''


def test_repro003_host_reads_in_a_registered_pivot_loop():
    path = "src/repro_torch/core/lp_kernel.py"
    got = found(lint.lint_source(HOT, path))
    # the loop's five reads and the helper's read; none outside the loop
    assert got == [("REPRO003", ln) for ln in (3, 8, 9, 10, 11, 12)]
    assert lint.lint_source(HOT, "src/repro_torch/core/other.py") == []
    quiet = with_allows(HOT, "REPRO003", {3, 8, 9, 10, 11, 12},
                        reason="declared read: tested")
    assert lint.lint_source(quiet, path) == []


def test_repro003_step_bodies_are_hot_whole():
    src = ("class UpdateStep:\n    def __call__(self, d):\n"
           "        return float(d.sum().item())\n")
    assert found(lint.lint_source(src, "src/repro_torch/core/distributed.py")
                 ) == [("REPRO003", 3)]


def test_repro005_torch_gathers_of_a_relation_column():
    src = "import torch\ndef f(table):\n    return torch.as_tensor(table['x'])\n"
    assert found(lint.lint_source(src, "a.py")) == [("REPRO005", 3)]
    assert ref_lint.lint_source(src, "a.py") == []


# ------------------------------------------------------- ratchet, models


def test_ratchet_matches_the_reference():
    src = SNIPPETS["REPRO004"] * 3 + SNIPPETS["REPRO006"]
    mine = lint.lint_source(src, "a.py")
    theirs = ref_lint.lint_source(src, "a.py")
    assert found(mine) == found(theirs)
    assert report.count_by_key(mine) == ref_report.count_by_key(theirs)
    for pinned in ({"REPRO004:a.py": 2}, {"REPRO004:a.py": 5,
                                          "REPRO006:a.py": 1,
                                          "REPRO007:b.py": 1}, {}):
        new, shrunk, stale = report.compare_baseline(mine, pinned)
        rnew, rshrunk, rstale = ref_report.compare_baseline(theirs, pinned)
        assert [(v.key, v.line) for v in new] == \
            [(v.key, v.line) for v in rnew]
        assert (shrunk, stale) == (rshrunk, rstale)


def test_baseline_round_trip_matches_the_reference(tmp_path):
    pinned = {"REPRO005:x.py": 2, "IRC002:a@w2": 1}
    report.save_baseline(str(tmp_path / "a.json"), pinned)
    ref_report.save_baseline(str(tmp_path / "b.json"), pinned)
    assert (tmp_path / "a.json").read_text() == \
        (tmp_path / "b.json").read_text()
    assert ref_report.load_baseline(str(tmp_path / "a.json")) == pinned


def _reference_budget():
    """``pq_collective_budget`` and ``BUDGET_HEADROOM`` from the source of
    ``repro/analysis/contracts.py`` (executed alone: the module imports
    JAX)."""
    path = os.path.join(ROOT, "src", "repro", "analysis", "contracts.py")
    tree = ast.parse(open(path).read())
    keep = [n for n in tree.body if (isinstance(n, ast.FunctionDef)
                                     and n.name == "pq_collective_budget")
            or (isinstance(n, ast.Assign) and any(
                getattr(t, "id", "") == "BUDGET_HEADROOM"
                for t in n.targets))]
    assert len(keep) == 2
    ns = {}
    exec(compile(ast.Module(keep, []), path, "exec"), ns)
    return ns["pq_collective_budget"], ns["BUDGET_HEADROOM"]


def test_pq_collective_budget_matches_the_reference():
    ref, headroom = _reference_budget()
    assert collectives.BUDGET_HEADROOM == headroom
    for p in (1, 2, 4, 16, 256):
        for m in (1, 8, 12, 64):
            for nb in (16, 128):
                for k in (1, 32, 128):
                    for db in (4, 8):
                        assert collectives.pq_collective_budget(
                            p, m, nb, k, db) == ref(p, m, nb, k, db)


HLO_KIND = {"all-gather": "f64[{n}] all-gather(%x), dimensions={{0}}",
            "all-reduce": "f64[{n}] all-reduce(%x), to_apply=%sum",
            "reduce-scatter": "f64[{n}] reduce-scatter(%x), "
                              "dimensions={{0}}, to_apply=%sum",
            "all-to-all": "f64[{n}] all-to-all(%x), dimensions={{0}}",
            "collective-permute": "f64[{n}] collective-permute(%x), "
                                  "source_target_pairs={{{{0,1}},{{1,0}}}}"}


def _one_collective_hlo(kind: str, n: int, group: int) -> str:
    groups = "{" + ",".join(str(i) for i in range(group)) + "}"
    op = HLO_KIND[kind].format(n=n)
    rg = "" if kind == "collective-permute" \
        else f", replica_groups={{{groups}}}"
    return (f"HloModule one\n\nENTRY %main (x: f64[{n}]) -> f64[{n}] {{\n"
            f"  %x = f64[{n}] parameter(0)\n"
            f"  ROOT %c = {op}{rg}\n}}\n")


@pytest.mark.parametrize("kind", sorted(HLO_KIND))
def test_ring_model_matches_hlo_analysis(kind):
    for group in (2, 4, 8):
        n = 96
        st = hlo_analysis.collective_bytes(_one_collective_hlo(kind, n, group),
                                           default_group=group)
        assert st.count_by_kind == {kind: 1}
        rec = collectives.CollectiveRecord(kind, n * 8, group)
        assert rec.link_bytes == pytest.approx(st.total_bytes, rel=0,
                                               abs=1e-9)
        mine = collectives.collective_stats([rec, rec], per=2)
        assert mine.total_bytes == pytest.approx(st.total_bytes)


# --------------------------------------------------------- the port's head


def test_port_head_is_clean_against_its_baseline():
    vs, n_files = lint.lint_paths(lint.DEFAULT_LINT_DIRS, root=ROOT)
    cs, _ = concurrency.check_paths(lint.DEFAULT_LINT_DIRS, root=ROOT)
    assert n_files > 70
    pinned = report.load_baseline(BASELINE)
    assert pinned == {"REPRO005:src/repro_torch/core/paql.py": 2}
    new, shrunk, stale = report.compare_baseline(vs + cs, pinned)
    assert new == [], "new violations:\n" + "\n".join(
        v.format() for v in new)
    assert shrunk == [] and stale == []


def test_port_head_has_zero_concurrency_debt():
    vs, n_files = concurrency.check_paths(lint.DEFAULT_LINT_DIRS, root=ROOT)
    assert n_files > 70
    assert vs == [], "concurrency violations:\n" + "\n".join(
        v.format() for v in vs)


@pytest.mark.parametrize("rel,rule,least", [
    ("src/repro_torch/core/lp_kernel.py", "REPRO003", 1),
    ("src/repro_torch/core/lp_kernel.py", "REPRO006", 1),
    ("src/repro_torch/core/distributed.py", "REPRO003", 3),
    ("src/repro_torch/core/distributed.py", "REPRO009", 1),
    ("src/repro_torch/serving/scheduler.py", "REPRO011", 1),
    ("src/repro_torch/serving/scheduler.py", "REPRO004", 1),
])
def test_suppressed_sites_detectably_in_scope(rel, rule, least):
    """The clean head is real detection: without the allow markers the
    rules fire again at the declared and by-design sites."""
    with open(os.path.join(ROOT, rel)) as f:
        src = f.read().replace("repro: allow", "repro: unallow")
    vs = [v for v in port_scan(src, rel) if v.rule == rule]
    assert len(vs) >= least, f"{rule} no longer detected in {rel}"


# ------------------------------------------------------------------- CLI

PORT_SNIPPETS = {**{r: SNIPPETS[r] for r in SAME_RULES},
                 "REPRO005": SNIPPETS["REPRO005"]}


@pytest.mark.parametrize("rule", sorted(PORT_SNIPPETS))
def test_cli_exits_nonzero_on_seeded_violation(rule, tmp_path):
    from repro_torch.analysis.__main__ import main
    (tmp_path / "seeded.py").write_text(PORT_SNIPPETS[rule])
    out = tmp_path / "analysis.json"
    rc = main(["--grid", "none", "--root", str(tmp_path),
               "--lint-dir", ".", "--out", str(out)])
    assert rc == 1
    rep = json.loads(out.read_text())
    assert rep["exit_code"] == 1
    assert any(v["rule"] == rule for v in rep["lint"]["violations"])


@pytest.mark.parametrize("rule,rel,src", [
    ("REPRO002", "src/repro_torch/core/lp.py", F32_SNIPPETS["full"]),
    ("REPRO003", "src/repro_torch/core/lp_kernel.py", HOT),
])
def test_cli_exits_nonzero_on_seeded_torch_form(rule, rel, src, tmp_path):
    from repro_torch.analysis.__main__ import main
    (tmp_path / rel).parent.mkdir(parents=True)
    (tmp_path / rel).write_text(src)
    out = tmp_path / "analysis.json"
    rc = main(["--grid", "none", "--root", str(tmp_path),
               "--lint-dir", "src", "--out", str(out)])
    assert rc == 1
    assert any(v["rule"] == rule and v["path"] == rel
               for v in json.loads(out.read_text())["lint"]["violations"])


def test_cli_port_head_with_baseline_passes(tmp_path):
    from repro_torch.analysis.__main__ import main
    out = tmp_path / "analysis.json"
    rc = main(["--grid", "none", "--root", ROOT, "--baseline", BASELINE,
               "--out", str(out)])
    assert rc == 0
    rep = json.loads(out.read_text())
    assert rep["exit_code"] == 0 and rep["grid"] == "none"
    assert rep["baseline"]["new"] == [] and rep["baseline"]["stale"] == []


def test_cli_update_baseline_refuses_to_grow(tmp_path):
    from repro_torch.analysis.__main__ import main
    (tmp_path / "seeded.py").write_text(SNIPPETS["REPRO004"])
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"version": 1, "pinned": {}}))
    rc = main(["--grid", "none", "--root", str(tmp_path),
               "--lint-dir", ".", "--baseline", str(base),
               "--update-baseline", "--out", str(tmp_path / "a.json")])
    assert rc == 2
    assert report.load_baseline(str(base)) == {}     # pin file untouched


def test_cli_update_baseline_shrinks(tmp_path):
    from repro_torch.analysis.__main__ import main
    (tmp_path / "seeded.py").write_text(SNIPPETS["REPRO004"])
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"version": 1, "pinned": {
        "REPRO004:seeded.py": 3, "REPRO006:gone.py": 1}}))
    rc = main(["--grid", "none", "--root", str(tmp_path),
               "--lint-dir", ".", "--baseline", str(base),
               "--update-baseline", "--out", str(tmp_path / "a.json")])
    assert rc == 0
    assert report.load_baseline(str(base)) == {"REPRO004:seeded.py": 1}


def test_cli_default_report_is_not_the_references():
    from repro_torch.analysis.__main__ import _parse
    assert _parse([]).out == "build/analysis_torch.json"
    assert _parse([]).grid == "host"
