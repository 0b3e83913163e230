"""Finding record, inline suppressions, and the checked-in baseline.

A finding is identified for baseline purposes by ``(code, path,
line_text)`` — the stripped source text of the offending line — so the
baseline survives unrelated edits that shift line numbers.  Identical
entries are counted: a file may legitimately carry two baselined findings
with the same source text, and a third appearance is *new*.

Inline suppression syntax (preferred over baselining; forces a written
reason next to the exemption)::

    x = torch.einsum("td,edf->etf", xt, p[k])  # lint: allow=RP001 ideal-only

The marker may sit on the offending line or on the line directly above
(for lines too long to annotate in place).

Counterpart of ``repro.analysis.findings`` (the same records and file
format; standard library only).
"""

from __future__ import annotations

import json
import re
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

_ALLOW_RE = re.compile(r"#\s*lint:\s*allow=([A-Z0-9,]+)")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    code: str            # e.g. "RP001"
    path: str            # repo-relative, forward slashes
    line: int            # 1-based
    col: int             # 0-based
    message: str
    fix_hint: str
    line_text: str = ""  # stripped source of the offending line

    def key(self) -> Tuple[str, str, str]:
        return (self.code, self.path, self.line_text)

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col + 1}: "
                f"{self.code} {self.message}\n    hint: {self.fix_hint}")


def parse_suppressions(source: str) -> Dict[int, List[str]]:
    """Map line number -> list of rule codes allowed on that line.

    A marker on line N suppresses findings on lines N and N+1, so a
    comment can ride above a long statement.
    """
    allowed: Dict[int, List[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _ALLOW_RE.search(text)
        if not m:
            continue
        codes = [c for c in m.group(1).split(",") if c]
        allowed.setdefault(i, []).extend(codes)
        allowed.setdefault(i + 1, []).extend(codes)
    return allowed


def suppressed(finding: Finding, allowed: Dict[int, List[str]]) -> bool:
    return finding.code in allowed.get(finding.line, ())


# ---- baseline ---------------------------------------------------------------


def write_baseline(findings: Iterable[Finding], path: Path) -> None:
    """Serialize findings (deduped with counts) as the suppression baseline."""
    counts = Counter(f.key() for f in findings)
    entries = [
        {"code": code, "path": p, "line_text": text, "count": n}
        for (code, p, text), n in sorted(counts.items())
    ]
    path.write_text(json.dumps({"version": 1, "findings": entries},
                               indent=2, sort_keys=True) + "\n")


def load_baseline(path: Path) -> Counter:
    """Baseline as a Counter over finding keys; empty if the file is absent."""
    if not path.is_file():
        return Counter()
    payload = json.loads(path.read_text())
    counts: Counter = Counter()
    for e in payload.get("findings", []):
        counts[(e["code"], e["path"], e.get("line_text", ""))] = \
            int(e.get("count", 1))
    return counts


def apply_baseline(findings: List[Finding],
                   baseline: Counter) -> List[Finding]:
    """Return findings not absorbed by the baseline (order preserved)."""
    budget = Counter(baseline)
    fresh: List[Finding] = []
    for f in findings:
        if budget[f.key()] > 0:
            budget[f.key()] -= 1
        else:
            fresh.append(f)
    return fresh
