"""The port's lint (`repro_torch.analysis`): rule fixtures, suppressions,
baseline, CLI, the self-scan gate over src/repro_torch, the card sync
audit's mapping, and parity with the reference's `repro.analysis` on the
same inputs (unit parsing, R004, the call graph, fingerprints, baselines,
reports)."""
import ast
import collections
import json
import subprocess
import sys
from pathlib import Path

import pytest

import torch_analysis_fixtures as fx
from repro.analysis import callgraph as ref_callgraph
from repro.analysis import engine as ref_engine
from repro.analysis import findings as ref_findings
from repro.analysis import report as ref_report
from repro.analysis import rules as ref_rules
from repro_torch.analysis import audit, callgraph, engine, findings, report
from repro_torch.analysis.__main__ import BASELINE
from repro_torch.analysis.__main__ import main as lint_main
from repro_torch.analysis.engine import analyze
from repro_torch.analysis.findings import (SuppressionIndex, load_baseline,
                                           write_baseline)
from repro_torch.analysis.rules import RULES, parse_unit

REPO = Path(__file__).resolve().parents[1]
SRC_PORT = REPO / "src" / "repro_torch"
SRC_REF = REPO / "src" / "repro"
ALL_RULES = ("R001", "R002", "R003", "R004", "R005", "R006")

# every rule's bad fixture must produce at least this many findings —
# pinned so a rule silently losing a detector fails loudly here
MIN_BAD_FINDINGS = {"R001": 6, "R002": 10, "R003": 7,
                    "R004": 6, "R005": 6, "R006": 4}


def _scan(paths, rules=None, baseline=None):
    return analyze([str(p) for p in paths], rules=rules,
                   baseline_path=baseline)


def _rows(result):
    return [(fp, f.rule, f.path, f.line, f.col, f.message, f.suggestion)
            for fp, f in result.new]


# ---------------------------------------------------------------- rules

def test_registry_complete():
    assert tuple(sorted(RULES)) == ALL_RULES
    for rid, rule in RULES.items():
        assert rule.id == rid
        assert rule.title and rule.contract
        assert "jax" not in (rule.title + rule.contract).lower()


@pytest.mark.parametrize("rid", ALL_RULES)
def test_bad_fixture_fires(tmp_path, rid):
    res = _scan([fx.write(tmp_path, rid, "bad")], rules=[rid])
    hits = [f for _, f in res.new if f.rule == rid]
    assert len(hits) >= MIN_BAD_FINDINGS[rid], \
        [f.message for _, f in res.new]
    assert res.exit_code == 1


@pytest.mark.parametrize("rid", ALL_RULES)
def test_good_fixture_silent(tmp_path, rid):
    res = _scan([fx.write(tmp_path, rid, "good")], rules=[rid])
    assert res.new == [], [f.message for _, f in res.new]
    assert res.exit_code == 0


def test_good_fixtures_silent_under_all_rules(tmp_path):
    # a good fixture must not trip a *different* rule either
    res = _scan([fx.write(tmp_path, r, "good") for r in ALL_RULES])
    assert res.new == [], [f.message for _, f in res.new]


@pytest.mark.parametrize("rid,needle", [
    ("R001", "ctypes.CDLL"), ("R001", "`if`"), ("R001", "`while`"),
    ("R001", "torch.func.grad built inside a loop"), ("R001", "of nvcc"),
    ("R001", "unhashable"),
    ("R002", "numpy.asarray"), ("R002", ".item()"), ("R002", "float()"),
    ("R002", ".cpu()"), ("R002", "print()"),
    ("R002", "torch.cuda.synchronize"), ("R002", "torch.tensor(..., device=)"),
    ("R002", "torch.nonzero()"), ("R002", "Python scalar"),
    ("R002", "module-level `STATS`"),
    ("R003", "np.random.rand"), ("R003", "torch.manual_seed"),
    ("R003", "torch.randn without generator="), ("R003", "CUDA device"),
    ("R003", ".normal_()"), ("R003", "inside a loop"), ("R003", "re-seeded"),
    ("R005", "unhashable container"), ("R005", "tensor-valued"),
    ("R005", "id()-keyed"), ("R005", "data_ptr()"), ("R005", "raw array bytes"),
    ("R005", "torch.Tensor"),
    ("R006", "cat inside a per-step loop"), ("R006", "list append"),
    ("R006", ".double()"), ("R006", "float64 reference"),
])
def test_each_detector_fires(tmp_path, rid, needle):
    res = _scan([fx.write(tmp_path, rid, "bad")], rules=[rid])
    assert any(needle in f.message for _, f in res.new), \
        [f.message for _, f in res.new]


def test_hot_set_follows_torch_tracers(tmp_path):
    # module forwards, autograd Functions, torch.func bodies and
    # checkpointed layers are roots; lru_cache'd builders stop the walk
    f = tmp_path / "tracers.py"
    f.write_text(
        "import functools\n"
        "import torch\n"
        "from torch.utils.checkpoint import checkpoint\n\n"
        "class Op(torch.autograd.Function):\n"
        "    @staticmethod\n"
        "    def backward(ctx, g):\n"
        "        return helper(g)\n\n"
        "def helper(g):\n"
        "    return g\n\n"
        "def layer(x):\n"
        "    return x\n\n"
        "def body(x):\n"
        "    return built(3) + x\n\n"
        "@functools.lru_cache(maxsize=1)\n"
        "def built(n):\n"
        "    return n\n\n"
        "def cold(x):\n"
        "    return checkpoint(layer, x, use_reentrant=False) + "
        "torch.func.vmap(body)(x)\n")
    hot = {q.rsplit(".", 1)[-1] for q in _scan([f]).context.hot}
    assert {"backward", "helper", "layer", "body"} <= hot
    assert not {"built", "cold"} & hot


def test_explicit_roots_name_the_port_paths():
    hot = _scan([SRC_PORT], rules=["R004"]).context.hot
    for q in ("core.daysim._row_stage.<locals>.stage",
              "core.daysim._run_batch", "core.daysim._fused_pipeline",
              "core.daysim._summarize_torch", "core.dse.non_dominated_torch",
              "core.autoscale._scale_scan", "core.fleet._run_chunk",
              "models.mamba_lm.decode_step", "models.transformer.prefill",
              "models.whisper.loss_fn", "training.optimizer.update",
              "kernels.day_scan.day_scan", "kernels.ssd_scan.ssd_scan",
              "kernels.flash_attention.flash_attention"):
        assert f"repro_torch.{q}" in hot, q
    # builders behind an lru_cache stay out of it: the kernels' loads
    for q in ("kernels.flash_attention._lib", "kernels.ssd_scan._bwd_lib",
              "kernels.day_scan._entry", "kernels.build.load"):
        assert f"repro_torch.{q}" not in hot, q


@pytest.mark.parametrize("module,loader", [
    ("day_scan", "_entry"), ("flash_attention", "_lib"),
    ("flash_attention", "_bwd_lib"), ("ssd_scan", "_lib"),
    ("ssd_scan", "_bwd_lib")])
def test_r001_pins_the_cached_kernel_loads(tmp_path, module, loader):
    """A copy of the kernels with one loader's lru_cache removed: its
    `build.load` is then reached per call from a hot function."""
    kernels = tmp_path / "src" / "repro_torch" / "kernels"
    kernels.mkdir(parents=True)
    for p in (SRC_PORT / "kernels").glob("*.py"):
        (kernels / p.name).write_text(p.read_text())
    path = kernels / f"{module}.py"
    lines = path.read_text().splitlines(keepends=True)
    at = next(i for i, line in enumerate(lines)
              if line.startswith(f"def {loader}("))
    assert "lru_cache" in lines[at - 1]
    path.write_text("".join(lines[:at - 1] + lines[at:]))
    assert _scan([SRC_PORT / "kernels"], rules=["R001"]).new == []
    res = _scan([kernels], rules=["R001"])
    assert any("build.load" in f.message and f.path.endswith(path.name)
               for _, f in res.new), [f.message for _, f in res.new]


# --------------------------------------------------------- unit algebra

def test_unit_parse_decomposes_compound_suffixes():
    assert parse_unit("p_mw") == {"mw": 1}
    assert parse_unit("e_mwh") == {"mw": 1, "h": 1}
    assert parse_unit("e_kwh") == {"kw": 1, "h": 1}
    assert parse_unit("total") is None


def test_unit_parse_keeps_negative_exponents():
    assert parse_unit("usd_per_kwh") == {"usd": 1, "kw": -1, "h": -1}
    assert parse_unit("mw_per_mbps") == {"mw": 1, "mbps": -1}


# ---------------------------------------------------------- suppression

def test_same_line_suppression_matches(tmp_path):
    f = tmp_path / "sup.py"
    f.write_text("import torch\n"
                 "x = torch.rand(4)  "
                 "# repro: ignore[R003]: frozen fixture data\n")
    res = _scan([f], rules=["R003"])
    assert res.new == []
    assert len(res.suppressed) == 1
    assert res.suppressed[0][1] == "frozen fixture data"
    assert res.unused_suppressions == []


def test_standalone_comment_guards_next_source_line(tmp_path):
    f = tmp_path / "sup.py"
    f.write_text("import torch\n"
                 "# repro: ignore[R003]: deliberate legacy draw,\n"
                 "# continued reason on a second comment line\n"
                 "x = torch.rand(4)\n")
    res = _scan([f], rules=["R003"])
    assert res.new == []
    assert len(res.suppressed) == 1


def test_suppression_without_reason_is_reported(tmp_path):
    f = tmp_path / "sup.py"
    f.write_text("import torch\n"
                 "x = torch.rand(4)  # repro: ignore[R003]\n")
    res = _scan([f], rules=["R003"])
    assert sorted(f.rule for _, f in res.new) == ["R000", "R003"]


def test_unused_suppression_surfaces(tmp_path):
    f = tmp_path / "sup.py"
    f.write_text("x = 1  # repro: ignore[R003]: nothing fires here\n")
    res = _scan([f], rules=["R003"])
    assert res.new == []
    assert len(res.unused_suppressions) == 1


def test_suppression_is_rule_specific(tmp_path):
    f = tmp_path / "sup.py"
    f.write_text("import torch\n"
                 "x = torch.rand(4)  "
                 "# repro: ignore[R001]: wrong rule id\n")
    res = _scan([f], rules=["R003"])
    assert [f.rule for _, f in res.new] == ["R003"]


def test_suppression_index_matches_the_reference():
    src = ("import torch\n"
           "# repro: ignore[R002, R006]: two rules,\n"
           "# one reason\n"
           "x = torch.rand(4)  # repro: ignore[R003]\n"
           "y = 1  # repro: ignore[R004]: kept\n")
    port = SuppressionIndex(src, "m.py")
    ref = ref_findings.SuppressionIndex(src, "m.py")
    assert {k: [(s.line, s.rules, s.reason, s.comment_line) for s in v]
            for k, v in port.by_line.items()} == {
        k: [(s.line, s.rules, s.reason, s.comment_line) for s in v]
        for k, v in ref.by_line.items()}
    assert [f.as_dict() for f in port.malformed] == \
        [f.as_dict() for f in ref.malformed]


# -------------------------------------------------------------- baseline

def test_baseline_round_trip(tmp_path):
    f = fx.write(tmp_path, "R003", "bad")
    first = _scan([f], rules=["R003"])
    n = len(first.new)
    assert n >= MIN_BAD_FINDINGS["R003"]
    bl = tmp_path / "baseline.json"
    write_baseline(bl, [fi for _, fi in first.new])
    assert len(load_baseline(bl)) == n
    second = _scan([f], rules=["R003"], baseline=bl)
    assert second.new == []
    assert len(second.baselined) == n
    assert second.exit_code == 0


def test_baseline_survives_line_drift(tmp_path):
    f = fx.write(tmp_path, "R003", "bad")
    src = f.read_text()
    first = _scan([f], rules=["R003"])
    bl = tmp_path / "baseline.json"
    write_baseline(bl, [fi for _, fi in first.new])
    f.write_text("# a new leading comment\n\n" + src)
    shifted = _scan([f], rules=["R003"], baseline=bl)
    assert shifted.new == []
    assert len(shifted.baselined) == len(first.new)


def test_baseline_does_not_hide_new_instances(tmp_path):
    f = tmp_path / "mod.py"
    f.write_text("import torch\n"
                 "a = torch.rand(4)\n")
    bl = tmp_path / "baseline.json"
    write_baseline(bl, [fi for _, fi in _scan([f], rules=["R003"]).new])
    f.write_text("import torch\n"
                 "a = torch.rand(4)\n"
                 "b = torch.randn(4)\n")
    res = _scan([f], rules=["R003"], baseline=bl)
    assert len(res.baselined) == 1
    assert len(res.new) == 1
    assert res.exit_code == 1


def test_port_baseline_entries_exist():
    entries = json.loads(BASELINE.read_text())
    assert entries["version"] == 1
    for e in entries["findings"]:
        assert e["path"].startswith("src/repro_torch/"), e
        assert (REPO / e["path"]).is_file(), e
        assert e["rule"] in ALL_RULES, e


# ------------------------------------------------------------------ CLI

def test_cli_json_format(tmp_path, capsys):
    rc = lint_main([str(fx.write(tmp_path, "R003", "bad")), "--rules=R003",
                    "--no-baseline", "--format=json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1 and out["exit_code"] == 1
    assert all(f["rule"] == "R003" for f in out["new"])
    assert all(f["fingerprint"] for f in out["new"])


def test_cli_github_format(tmp_path, capsys):
    rc = lint_main([str(fx.write(tmp_path, "R002", "bad")), "--rules=R002",
                    "--no-baseline", "--format=github"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "::error file=" in out and "title=R002" in out


def test_cli_fix_suggestions(tmp_path, capsys):
    rc = lint_main([str(fx.write(tmp_path, "R003", "bad")),
                    str(fx.write(tmp_path, "R004", "bad")),
                    "--no-baseline", "--fix-suggestions"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "fix: torch.Generator().manual_seed" in out or \
        "fix: gen = torch.Generator().manual_seed" in out
    assert "fix:" in out


def test_cli_list_rules(capsys):
    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in ALL_RULES:
        assert rid in out


def test_cli_rejects_unknown_rule(tmp_path):
    assert lint_main(["--rules=R999", str(tmp_path)]) == 2


def test_cli_defaults_to_the_port_and_its_baseline(monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    assert lint_main([]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    n_files = len(list(SRC_PORT.rglob("*.py")))
    assert f"across {n_files} file(s)" in out
    assert "0 finding(s)" in out


def test_cli_never_reads_the_reference_baseline(tmp_path):
    # an analysis_baseline.json beside the scanned file (as the repo
    # root's sits above src/repro) grandfathers nothing for the port
    f = fx.write(tmp_path, "R003", "bad")
    write_baseline(tmp_path / "analysis_baseline.json",
                   [fi for _, fi in _scan([f], rules=["R003"]).new])
    assert lint_main([str(f), "--rules=R003"]) == 1


# ------------------------------------------------- tier-1 self-scan gate

def test_src_repro_torch_is_lint_clean():
    """The committed port must carry zero unsuppressed, unbaselined
    findings — the gate `chip_smoke.py` phase 31 also runs."""
    res = _scan([SRC_PORT], baseline=BASELINE)
    assert res.new == [], "\n".join(
        f"{f.path}:{f.line}: {f.rule} {f.message}" for _, f in res.new)
    assert res.exit_code == 0
    assert res.unused_suppressions == [], [
        (s.comment_line, sorted(s.rules)) for s in res.unused_suppressions]
    # every suppression says why, and every baseline entry still fires
    # (a PR that removes a lead regenerates the baseline)
    assert all(reason.strip() for _, reason in res.suppressed)
    assert len(res.baselined) == len(load_baseline(BASELINE))


def test_injected_bad_fixture_fails_the_gate(tmp_path):
    bad = [fx.write(tmp_path, r, "bad") for r in ALL_RULES]
    res = _scan([SRC_PORT, *bad], baseline=BASELINE)
    assert res.exit_code == 1
    fired = {f.rule for _, f in res.new}
    assert fired.issuperset(ALL_RULES), fired


@pytest.mark.parametrize("rid", ALL_RULES)
def test_each_bad_fixture_alone_fails_the_cli(tmp_path, monkeypatch, rid):
    monkeypatch.chdir(REPO)
    bad = fx.write(tmp_path, rid, "bad")
    assert lint_main([str(SRC_PORT), str(bad)]) == 1


def test_analysis_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.analysis as a\n"
        "from repro_torch.analysis import audit, callgraph, engine, "
        "findings, report, rules, __main__\n"
        "r = a.analyze(['src/repro_torch'], rules=['R004'])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
        "print(r.files_scanned)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True,
                         env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) > 0
    for p in (SRC_PORT / "analysis").glob("*.py"):
        tree = ast.parse(p.read_text())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
        mods |= {n.module or "" for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and not n.level}
        assert not {m for m in mods
                    if m.split(".")[0] in ("jax", "repro")}, (p, mods)


# --------------------------------------------------------- the sync audit

def test_audit_maps_sites_to_functions_and_findings():
    """`audit.classify` places a reported site in its function, the hot
    set and the findings on its statement (the card's phase 31 runs it on
    the syncs torch reports)."""
    res = _scan([SRC_PORT], baseline=BASELINE)
    ctx = res.context
    fl = {(f.path, f.rule): f for _, f in res.baselined}
    rope = fl[("src/repro_torch/nn/attention.py", "R002")]
    moe = next(f for f, _ in res.suppressed
               if f.path == "src/repro_torch/nn/moe.py")
    cold = next(info for info in ctx.graph.functions.values()
                if info.qualname == "repro_torch.core.dse.sensitivity_rows")
    sites = collections.Counter({
        (rope.path, rope.line + 1): 60,      # the statement's next line
        (moe.path, moe.line): 2,
        (cold.path, cold.node.body[-1].lineno): 1,
        None: 3})
    rows = {r["site"]: r for r in audit.classify(sites, res)}
    r = rows[f"{rope.path}:{rope.line + 1}"]
    assert (r["function"], r["hot"], r["covered"], r["rules"], r["syncs"]) \
        == ("repro_torch.nn.attention.rope", True, True, ["R002"], 60)
    r = rows[f"{moe.path}:{moe.line}"]
    assert r["hot"] and r["covered"] and \
        r["function"] == "repro_torch.nn.moe.moe_apply"
    r = rows[f"{cold.path}:{cold.node.body[-1].lineno}"]
    assert r["function"] == cold.qualname and not r["hot"]
    assert rows[None]["syncs"] == 3 and not rows[None]["hot"]


def test_audit_site_is_the_innermost_port_frame():
    # a callback run by a port function: the site is the port's call
    # line, not the test's frame around it
    import torch
    from repro_torch.core import dse
    sites = []

    def day_fn(point):
        sites.append(audit._port_site(sys._getframe()))
        return {"t_skin": torch.zeros(2), "soft_tte_h": torch.zeros(())}

    dse.policy_loss(day_fn, 40.0)(None)
    path = SRC_PORT / "core" / "dse.py"
    line = next(i for i, text in enumerate(path.read_text().splitlines(), 1)
                if "out = day_fn(point)" in text)
    assert sites == [("src/repro_torch/core/dse.py", line)]
    assert audit._port_site(sys._getframe()) is None


# --------------------------------------------- parity with repro.analysis

def _identifiers(root):
    out = set()
    for p in root.rglob("*.py"):
        for n in ast.walk(ast.parse(p.read_text())):
            if isinstance(n, ast.Name):
                out.add(n.id)
            elif isinstance(n, ast.Attribute):
                out.add(n.attr)
            elif isinstance(n, ast.arg):
                out.add(n.arg)
            elif isinstance(n, ast.Constant) and isinstance(n.value, str) \
                    and n.value.isidentifier():
                out.add(n.value)
    return out


def test_parse_unit_agrees_with_the_reference():
    names = _identifiers(SRC_REF) | _identifiers(SRC_PORT)
    assert len(names) > 3000
    diff = [n for n in sorted(names)
            if parse_unit(n) != ref_rules.parse_unit(n)]
    assert diff == []


@pytest.mark.parametrize("paths", [
    ("src/repro",),
    ("tests/fixtures/analysis/r004_bad.py",
     "tests/fixtures/analysis/r004_good.py"),
], ids=["src-repro", "r004-fixtures"])
def test_r004_findings_equal_the_reference(monkeypatch, paths):
    monkeypatch.chdir(REPO)
    port = analyze(list(paths), rules=["R004"])
    ref = ref_engine.analyze(list(paths), rules=["R004"])
    assert _rows(port) == _rows(ref)
    assert [(f.as_dict(), r) for f, r in port.suppressed] == \
        [(f.as_dict(), r) for f, r in ref.suppressed]
    if paths[0] != "src/repro":
        assert len(port.new) >= MIN_BAD_FINDINGS["R004"]


def test_expression_units_agree_with_the_reference():
    # src/repro carries no R004 finding, so hold the unit algebra itself
    # to the reference on every expression of both packages
    from repro_torch.analysis import rules as port_rules
    n = 0
    for root in (SRC_REF, SRC_PORT):
        for p in root.rglob("*.py"):
            for node in ast.walk(ast.parse(p.read_text())):
                if isinstance(node, ast.expr):
                    assert port_rules._expr_unit(node) == \
                        ref_rules._expr_unit(node), (p, ast.unparse(node))
                    n += port_rules._expr_unit(node) is not None
    assert n > 500


def _graph(mod, root):
    g = mod.CallGraph()
    for p in engine.collect_files([root]):
        g.add_module(engine._module_name(p), engine._repo_rel(p),
                     ast.parse(p.read_text()))
    g.finalize()
    return g


def _edges(g):
    return {(a, b) for a, bs in g.edges.items() for b in bs}


def test_call_graph_equals_the_reference_over_src_repro(monkeypatch):
    port, ref = _graph(callgraph, SRC_REF), _graph(ref_callgraph, SRC_REF)
    assert set(port.functions) == set(ref.functions)
    assert port.children == ref.children
    assert port.returns == ref.returns
    for q, info in port.functions.items():
        assert (info.parent, info.cached, info.path) == (
            ref.functions[q].parent, ref.functions[q].cached,
            ref.functions[q].path), q
    # the port's torch tracers find no body in the JAX package ...
    assert not any(i.traced for i in port.functions.values())
    # ... so its edges are the reference's with the reference's own
    # tracer table emptied: the same call edges, and the reference's
    # extra edges are the bodies it hands jax.jit / vmap / lax.scan
    monkeypatch.setattr(ref_callgraph, "_TRACERS", {})
    monkeypatch.setattr(ref_callgraph, "_TRACER_SUFFIXES", {})
    plain = _graph(ref_callgraph, SRC_REF)
    assert _edges(port) == _edges(plain)
    assert _edges(port) < _edges(ref)


def test_fingerprints_equal_the_reference():
    f = findings.Finding("R002", "src/repro_torch/x.py", 3, 4, "msg",
                         snippet="y = x.item()")
    g = ref_findings.Finding("R002", "src/repro_torch/x.py", 3, 4, "msg",
                             snippet="y = x.item()")
    for occ in (0, 1, 7):
        assert f.fingerprint(occ) == g.fingerprint(occ)
    many = [f, f, findings.Finding("R003", "a.py", 1, 0, "m", snippet="s")]
    assert list(findings.assign_fingerprints(many)) == list(
        ref_findings.assign_fingerprints(
            [ref_findings.Finding(**x.as_dict()) for x in many]))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_baselines_cross_read(tmp_path, writer):
    res = _scan([fx.write(tmp_path, "R003", "bad"),
                 fx.write(tmp_path, "R005", "bad")])
    items = [fi for _, fi in res.new]
    bl = tmp_path / "baseline.json"
    if writer == "port":
        write_baseline(bl, items)
        assert ref_findings.load_baseline(bl) == load_baseline(bl)
    else:
        ref_findings.write_baseline(
            bl, [ref_findings.Finding(**fi.as_dict()) for fi in items])
        other = tmp_path / "port.json"
        write_baseline(other, items)
        assert bl.read_text() == other.read_text()
    again = _scan([tmp_path / "r003_bad.py", tmp_path / "r005_bad.py"],
                  baseline=bl)
    assert again.new == [] and len(again.baselined) == len(items)


def test_reports_equal_the_reference(tmp_path):
    f = fx.write(tmp_path, "R004", "bad")
    f.write_text(f.read_text()
                 + "x_h = 1  # repro: ignore[R003]: an unused note\n")
    port = analyze([str(f), str(fx.write(tmp_path, "R003", "bad"))])
    assert port.new and port.unused_suppressions
    ref = ref_engine.AnalysisResult(
        [(fp, ref_findings.Finding(**fi.as_dict())) for fp, fi in port.new],
        [(ref_findings.Finding(**fi.as_dict()), r)
         for fi, r in port.suppressed],
        [(fp, ref_findings.Finding(**fi.as_dict()))
         for fp, fi in port.baselined],
        port.unused_suppressions, port.files_scanned, port.rules_run)
    assert report.format_text(port) == ref_report.format_text(ref)
    assert report.format_text(port, fix_suggestions=True) == \
        ref_report.format_text(ref, fix_suggestions=True)
    assert report.format_json(port) == ref_report.format_json(ref)
    assert report.format_github(port) == ref_report.format_github(ref)
    assert sorted(report.FORMATTERS) == sorted(ref_report.FORMATTERS)
