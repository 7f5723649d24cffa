"""The card's check of the static hot set: every synchronizing CUDA
operation torch reports on a path, mapped to the port's file:line.

``record_syncs`` runs a block under ``torch.cuda.set_sync_debug_mode
("warn")`` and counts each reported sync by the innermost frame of
``src/repro_torch`` that led to it (torch's own Python frames and the
caller's are skipped).  ``classify`` places each site in the function
around it and says whether that function is in the analysis' hot set
and whether a finding (new, suppressed or baselined) sits on the
statement: a hot-set site with no finding is one the rules miss.
"""
from __future__ import annotations

import ast
import collections
import contextlib
import os
import sys
import warnings
from pathlib import Path

from .engine import _repo_rel

PACKAGE = Path(__file__).resolve().parents[1]       # src/repro_torch
_OWN = Path(__file__).resolve().parent              # this analysis package
_SYNC_TEXT = "synchronizing CUDA operation"


def _port_site(frame) -> tuple | None:
    """(repo-relative path, line) of the innermost port frame, or None."""
    while frame is not None:
        path = Path(os.path.abspath(frame.f_code.co_filename))
        if PACKAGE in path.parents and _OWN not in path.parents:
            return _repo_rel(path), frame.f_lineno
        frame = frame.f_back
    return None


@contextlib.contextmanager
def record_syncs():
    """Yield a Counter {(path, line) or None: syncs} filled while the block
    runs: one count per synchronizing operation torch reports, keyed by
    the innermost port frame (None when no port frame led to it)."""
    import torch
    sites = collections.Counter()
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        show = warnings.showwarning

        def record(message, category, filename, lineno, file=None,
                   line=None):
            if _SYNC_TEXT in str(message):
                sites[_port_site(sys._getframe(1))] += 1
            else:
                show(message, category, filename, lineno, file, line)

        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode(mode)


def _header_span(stmt) -> tuple:
    """Lines of a statement itself: a compound statement's header only."""
    body = getattr(stmt, "body", None)
    if isinstance(body, list) and body:
        return stmt.lineno, max(stmt.lineno, body[0].lineno - 1)
    return stmt.lineno, stmt.end_lineno


def _statement(fctx, line: int) -> tuple:
    """(first, last) line of the innermost statement that holds `line`."""
    spans = [_header_span(n) for n in ast.walk(fctx.tree)
             if isinstance(n, ast.stmt)]
    return min(((lo, hi) for lo, hi in spans if lo <= line <= hi),
               key=lambda s: (s[1] - s[0], -s[0]), default=(line, line))


def _function_at(ctx, fctx, line: int):
    """The innermost function (FuncInfo) of the file around `line`."""
    best = None
    for info in ctx.functions_in(fctx):
        n = info.node
        if n.lineno <= line <= n.end_lineno and (
                best is None or n.lineno >= best.node.lineno):
            best = info
    return best


def classify(sites, result) -> list:
    """One dict a site: site, syncs, function, hot, covered, rules (the
    rule ids of the findings on its statement), sorted by site."""
    ctx = result.context
    files = {f.path: f for f in ctx.files}
    on_line = collections.defaultdict(set)
    for f in ([f for _, f in result.new] + [f for f, _ in result.suppressed]
              + [f for _, f in result.baselined]):
        on_line[(f.path, f.line)].add(f.rule)
    rows = []
    for site, n in sorted(sites.items(), key=lambda kv: str(kv[0])):
        if site is None:
            rows.append({"site": None, "syncs": n, "function": None,
                         "hot": False, "covered": False, "rules": []})
            continue
        path, line = site
        fctx = files.get(path)
        info = _function_at(ctx, fctx, line) if fctx else None
        lo, hi = _statement(fctx, line) if fctx else (line, line)
        rules = sorted(set().union(*(on_line[(path, i)]
                                     for i in range(lo, hi + 1))))
        rows.append({"site": f"{path}:{line}", "syncs": n,
                     "function": info.qualname if info else None,
                     "hot": bool(info and info.qualname in ctx.hot),
                     "covered": bool(rules), "rules": rules})
    return rows
