"""Output formatting: text (default), JSON, and GitHub annotations."""
from __future__ import annotations

import json


def format_text(result, fix_suggestions: bool = False) -> str:
    lines = []
    for fp, f in result.new:
        lines.append(f"{f.path}:{f.line}:{f.col}: {f.rule} {f.message}")
        if f.snippet:
            lines.append(f"    | {f.snippet}")
        if fix_suggestions and f.suggestion:
            lines.append(f"    fix: {f.suggestion}")
    if result.unused_suppressions:
        for s in result.unused_suppressions:
            lines.append(
                f"note: unused suppression at line {s.comment_line} "
                f"({', '.join(sorted(s.rules))}: {s.reason})")
    lines.append(
        f"{len(result.new)} finding(s) "
        f"({len(result.suppressed)} suppressed, "
        f"{len(result.baselined)} baselined) "
        f"across {result.files_scanned} file(s), "
        f"rules {','.join(result.rules_run)}")
    return "\n".join(lines)


def format_json(result) -> str:
    return json.dumps({
        "new": [dict(f.as_dict(), fingerprint=fp)
                for fp, f in result.new],
        "suppressed": [dict(f.as_dict(), reason=r)
                       for f, r in result.suppressed],
        "baselined": [dict(f.as_dict(), fingerprint=fp)
                      for fp, f in result.baselined],
        "files_scanned": result.files_scanned,
        "rules": result.rules_run,
        "exit_code": result.exit_code,
    }, indent=1)


def format_github(result) -> str:
    lines = []
    for _, f in result.new:
        msg = f.message.replace("\n", " ")
        lines.append(f"::error file={f.path},line={f.line},"
                     f"col={f.col},title={f.rule}::{msg}")
    return "\n".join(lines)


FORMATTERS = {"text": format_text, "json": format_json,
              "github": format_github}
