"""Analysis driver: files -> ASTs -> call graph -> rules -> findings.

The engine owns everything rule-agnostic: discovering sources, module
naming, the parent-pointer maps rules use for context checks, the hot
set (functions reachable from traced roots), suppression matching, and
the baseline diff.  Rules only ever see an ``AnalysisContext``.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path

from .callgraph import CallGraph
from .findings import (Finding, SuppressionIndex, assign_fingerprints,
                       load_baseline)
from .rules import RULES

# functions that run per call on device tensors but are reached from no
# torch transform: the port's per-call device paths, each with why
EXPLICIT_HOT_ROOTS = (
    # the row stage the day pipeline runs per query (a closure returned
    # out of the cached `_row_stage` builder)
    re.compile(r"\._row_stage\.<locals>\.stage$"),
    # the device half of every twin query / batch: row stages, gather,
    # one day-scan launch, summary, fronts
    re.compile(r"\.core\.daysim\._run_batch$"),
    # a query's assembly lookup and device push, per query
    re.compile(r"\.core\.daysim\._fused_pipeline$"),
    # the device summary of every day-scan launch
    re.compile(r"\.core\.daysim\._summarize_torch$"),
    # each twin batch's one copy of its summary to the host (the card
    # reports its sync per query)
    re.compile(r"\.core\.daysim\._reports$"),
    # the Pareto front of every batch and sweep
    re.compile(r"\.core\.dse\.non_dominated_torch$"),
    # the autoscaler's 288-step eager recurrence, and the call around it
    # (its inputs' push and its trajectories' copy back: per-call syncs
    # the card reports)
    re.compile(r"\.core\.autoscale\._scale_scan$"),
    re.compile(r"\.core\.autoscale\.simulate$"),
    # the projected Adam step of the gradient path (`optimize_policy`,
    # `fit_ensemble`): the card reports its per-step syncs
    re.compile(r"\.core\.design\.adam_update$"),
    # the fleet's per-chunk reductions around each day-scan launch
    re.compile(r"\.core\.fleet\._run_chunk$"),
    # every model family's per-call steps: serving, prefill, training
    re.compile(r"\.models\.\w+\.(forward|prefill|decode_step|loss_fn)$"),
    # the Server's loop: per-step token copies and the prompts' push
    # (methods keep the reference's class-less qualnames)
    re.compile(r"\.serving\.engine\.(run|_prefill_batch)$"),
    # the AdamW update of every train step
    re.compile(r"\.training\.optimizer\.update$"),
    # the three kernels' dispatch entry points
    re.compile(r"\.kernels\.day_scan\.day_scan$"),
    re.compile(r"\.kernels\.flash_attention\.flash_attention$"),
    re.compile(r"\.kernels\.ssd_scan\.ssd_scan$"),
)


class FileCtx:
    def __init__(self, path: str, module_name: str, tree: ast.Module,
                 source: str, mod):
        self.path = path
        self.module_name = module_name
        self.tree = tree
        self.lines = source.splitlines()
        self.mod = mod
        self.suppressions = SuppressionIndex(source, path)
        self._parents: dict[int, ast.AST] = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[id(child)] = parent

    def parent_of(self, node):
        return self._parents.get(id(node))

    def enclosing_def(self, node):
        p = self.parent_of(node)
        while p is not None:
            if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                return p
            p = self.parent_of(p)
        return self.tree

    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""


class AnalysisContext:
    def __init__(self, files, graph):
        self.files: list[FileCtx] = files
        self.graph: CallGraph = graph
        self._by_module = {f.module_name: f for f in files}
        self._func_by_node = {id(info.node): info
                              for info in graph.functions.values()}
        roots = graph.traced_functions()
        roots |= {q for q in graph.functions
                  if any(r.search(q) for r in EXPLICIT_HOT_ROOTS)}
        self.hot = graph.reachable_from(roots)

    def file_of(self, info) -> FileCtx | None:
        return self._by_module.get(info.module)

    def func_of_node(self, node):
        return self._func_by_node.get(id(node))

    def functions_in(self, fctx):
        return [info for info in self.graph.functions.values()
                if info.module == fctx.module_name
                and not isinstance(info.node, ast.Lambda)]

    def enclosing_function(self, fctx, node):
        d = fctx.enclosing_def(node)
        return None if isinstance(d, ast.Module) else d


@dataclasses.dataclass
class AnalysisResult:
    new: list              # [(fingerprint, Finding)]
    suppressed: list       # [(Finding, reason)]
    baselined: list        # [(fingerprint, Finding)]
    unused_suppressions: list
    files_scanned: int
    rules_run: list
    # the AnalysisContext (call graph, hot set) the rules ran on; the
    # sync audit maps a reported site to its function through it
    context: object = dataclasses.field(default=None, repr=False,
                                        compare=False)

    @property
    def exit_code(self) -> int:
        return 1 if self.new else 0


def _repo_rel(path: Path) -> str:
    """Normalize to a repo-relative posix path (anchored at ``src``) so
    finding paths — and the baseline fingerprints derived from them —
    are identical whether the scan was invoked with relative or
    absolute paths."""
    parts = path.resolve().parts if path.is_absolute() else path.parts
    if "src" in parts:
        return "/".join(parts[parts.index("src"):])
    try:
        return path.resolve().relative_to(Path.cwd()).as_posix()
    except ValueError:
        return path.as_posix()


def _module_name(path: Path) -> str:
    parts = list(path.with_suffix("").parts)
    for marker in ("src",):
        if marker in parts:
            parts = parts[parts.index(marker) + 1:]
            break
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(p for p in parts if p not in ("/", "")) or path.stem


def collect_files(paths) -> list[Path]:
    out = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            out.append(p)
    return out


def analyze(paths, rules=None, baseline_path=None) -> AnalysisResult:
    graph = CallGraph()
    files: list[FileCtx] = []
    parse_failures: list[Finding] = []
    for path in collect_files(paths):
        source = path.read_text()
        rel = _repo_rel(path)
        try:
            tree = ast.parse(source, filename=rel)
        except SyntaxError as e:
            parse_failures.append(Finding(
                "R000", rel, e.lineno or 1, 0,
                f"syntax error: {e.msg}"))
            continue
        name = _module_name(path)
        graph.add_module(name, rel, tree)
        files.append(FileCtx(rel, name, tree, source, graph.modules[name]))
    graph.finalize()
    ctx = AnalysisContext(files, graph)

    selected = [RULES[r] for r in (rules or sorted(RULES))]
    raw: list[Finding] = list(parse_failures)
    for fctx in files:
        raw.extend(fctx.suppressions.malformed)
    for r in selected:
        raw.extend(r.run(ctx))

    by_path = {f.path: f for f in files}
    filled = []
    for f in raw:
        fc = by_path.get(f.path)
        if fc is not None and not f.snippet:
            f = dataclasses.replace(f, snippet=fc.snippet(f.line))
        filled.append(f)

    suppressed, live = [], []
    for f in filled:
        fc = by_path.get(f.path)
        sup = fc.suppressions.match(f) if fc is not None else None
        if sup is not None:
            suppressed.append((f, sup.reason))
        else:
            live.append(f)

    baseline = load_baseline(baseline_path) if baseline_path else {}
    fps = assign_fingerprints(live)
    new, baselined = [], []
    for fp, f in sorted(fps.items(),
                        key=lambda kv: (kv[1].path, kv[1].line)):
        (baselined if fp in baseline else new).append((fp, f))

    unused = [s for fc in files for s in fc.suppressions.unused()]
    return AnalysisResult(new, suppressed, baselined, unused,
                          len(files), [r.id for r in selected], ctx)
