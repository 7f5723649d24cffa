"""Finding records, per-line suppressions, and the grandfather baseline.

A finding is one (rule, location, message) triple.  Suppressions are
source comments of the form::

    x = torch.rand(4)   # repro: ignore[R00x]: <reason>  (x = rule no.)

and apply to the physical line they sit on; a comment-only line applies
to the next *source* line instead (further comment-only lines may
continue the reason).  A suppression without a reason is itself
reported (R000)
so silenced findings stay auditable.

The baseline file (the port's ``analysis/baseline.json``) grandfathers known
findings by content fingerprint — rule + path + normalized source line +
occurrence index — so line-number drift does not resurrect them, while
any *new* instance of the same pattern still fails the run.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import re
from pathlib import Path

SUPPRESS_RE = re.compile(
    r"#\s*repro:\s*ignore\[(?P<rules>R\d{3}(?:\s*,\s*R\d{3})*)\]"
    r"(?::\s*(?P<reason>\S.*))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str                   # posix path as given to the engine
    line: int
    col: int
    message: str
    snippet: str = ""           # stripped source line the finding sits on
    suggestion: str = ""        # nearest compliant rewrite, if the rule
    #                             can offer one (R003 / R004)

    def fingerprint(self, occurrence: int = 0) -> str:
        blob = f"{self.rule}|{self.path}|{self.snippet}|{occurrence}"
        return hashlib.sha1(blob.encode()).hexdigest()[:16]

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Suppression:
    line: int                   # line the suppression APPLIES to
    rules: frozenset
    reason: str
    comment_line: int           # line the comment physically sits on
    used: bool = False


class SuppressionIndex:
    """All ``# repro: ignore[...]`` comments of one source file."""

    def __init__(self, source: str, path: str):
        self.path = path
        self.by_line: dict[int, list[Suppression]] = {}
        self.malformed: list[Finding] = []
        lines = source.splitlines()
        for i, text in enumerate(lines, start=1):
            m = SUPPRESS_RE.search(text)
            if m is None:
                continue
            rules = frozenset(r.strip() for r in m.group("rules").split(","))
            reason = (m.group("reason") or "").strip()
            target = i
            if text.strip().startswith("#"):
                # standalone comment guards the next source line (any
                # further comment-only lines may continue the reason)
                target = i + 1
                while (target <= len(lines)
                       and lines[target - 1].strip().startswith("#")):
                    target += 1
            if not reason:
                self.malformed.append(Finding(
                    "R000", path, i, text.index("#"),
                    "suppression without a reason — use "
                    "`# repro: ignore[R00x]: why`",
                    snippet=text.strip()))
                continue
            self.by_line.setdefault(target, []).append(
                Suppression(target, rules, reason, i))

    def match(self, finding: Finding) -> Suppression | None:
        for sup in self.by_line.get(finding.line, ()):
            if finding.rule in sup.rules:
                sup.used = True
                return sup
        return None

    def unused(self) -> list[Suppression]:
        return [s for sups in self.by_line.values()
                for s in sups if not s.used]


def assign_fingerprints(findings: list[Finding]) -> dict[str, Finding]:
    """Stable content fingerprints; duplicates get an occurrence index."""
    seen: dict[tuple, int] = {}
    out: dict[str, Finding] = {}
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)):
        key = (f.rule, f.path, f.snippet)
        occ = seen.get(key, 0)
        seen[key] = occ + 1
        out[f.fingerprint(occ)] = f
    return out


def load_baseline(path: Path) -> dict:
    try:
        data = json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError):
        return {}
    return {e["fingerprint"]: e for e in data.get("findings", ())}


def write_baseline(path: Path, findings: list[Finding]) -> None:
    fps = assign_fingerprints(findings)
    entries = [{"fingerprint": fp, "rule": f.rule, "path": f.path,
                "line": f.line, "message": f.message}
               for fp, f in sorted(fps.items(), key=lambda kv: (
                   kv[1].path, kv[1].line, kv[1].rule))]
    Path(path).write_text(json.dumps(
        {"version": 1, "findings": entries}, indent=1) + "\n")
