"""File walker: parse, run scope-matched rules, apply suppressions/baseline.

``lint_paths`` is the programmatic entry point used by both the CLI and CI:
it returns ``(fresh, suppressed_count)`` where *fresh* are findings not
absorbed by an inline ``# lint: allow=`` marker or the checked-in baseline.

Counterpart of ``repro.analysis.checker``; the port's baseline is its own
file, ``lint_baseline_torch.json`` (``lint_baseline.json`` is the JAX
package's).
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple

from .findings import (Finding, apply_baseline, load_baseline,
                       parse_suppressions, suppressed)
from .rules import RULES, Rule, RuleContext

DEFAULT_BASELINE = "lint_baseline_torch.json"


def repo_relative(path: Path, root: Optional[Path] = None) -> str:
    """Posix path relative to *root* (or its best-effort anchor).

    Falls back to the segment chain after a recognizable anchor
    (``src`` or ``tests``) so fixture trees resolve rule scopes the same
    way the real tree does.
    """
    p = path.resolve()
    if root is not None:
        try:
            return p.relative_to(root.resolve()).as_posix()
        except ValueError:
            pass
    parts = p.parts
    for anchor in ("src", "tests"):
        if anchor in parts:
            return Path(*parts[parts.index(anchor):]).as_posix()
    return p.name


def lint_source(source: str, rel_path: str,
                rules: Sequence[Rule] = RULES) -> List[Finding]:
    """All findings for one in-memory source blob (suppressions applied,
    baseline not)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(code="RP000", path=rel_path, line=e.lineno or 1,
                        col=(e.offset or 1) - 1,
                        message=f"syntax error: {e.msg}",
                        fix_hint="fix the parse error before linting",
                        line_text="")]
    from .rules import build_import_table
    ctx = RuleContext(path=rel_path, tree=tree,
                      imports=build_import_table(tree),
                      lines=source.splitlines())
    allowed = parse_suppressions(source)
    out: List[Finding] = []
    for rule in rules:
        if not rule.applies_to(ctx):
            continue
        for f in rule.check(ctx):
            if not suppressed(f, allowed):
                out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return out


def lint_file(path: Path, root: Optional[Path] = None,
              rules: Sequence[Rule] = RULES) -> List[Finding]:
    return lint_source(path.read_text(), repo_relative(path, root), rules)


def iter_python_files(paths: Iterable[Path]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        if p.is_dir():
            files.extend(sorted(q for q in p.rglob("*.py")
                                if "__pycache__" not in q.parts))
        elif p.suffix == ".py":
            files.append(p)
    return files


def lint_paths(paths: Sequence[Path], root: Optional[Path] = None,
               baseline_path: Optional[Path] = None,
               rules: Sequence[Rule] = RULES,
               ) -> Tuple[List[Finding], int]:
    """Lint files/trees; returns (fresh findings, baselined count)."""
    findings: List[Finding] = []
    for f in iter_python_files(paths):
        findings.extend(lint_file(f, root, rules))
    if baseline_path is None:
        return findings, 0
    baseline = load_baseline(baseline_path)
    fresh = apply_baseline(findings, baseline)
    return fresh, len(findings) - len(fresh)
