"""The AST lint (port of ``repro.analysis.astlint``): parse, collect
suppressions, run every rule of :mod:`repro_torch.analysis.rules`.

Suppression syntax — on the flagged line or the line directly above::

    torch.backends.cudnn.allow_tf32 = True  # lint: ignore[TF32-ON] the
                                            # TF32 timing baseline

A suppression must carry a justifying reason after the bracket; a bare
``# lint: ignore[...]`` suppresses nothing and is itself reported
(``LINT-SUPPRESS``), so silencing a rule always leaves a written "why"
next to the code.
"""
from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from typing import Iterable, List, Set

from repro_torch.analysis.diagnostics import Diagnostic, diag
from repro_torch.analysis.rules import ALL_RULES, FileContext

_SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*ignore\[([A-Z0-9*,\- ]+)\]\s*(.*)")


def _collect_suppressions(source: str, ctx: FileContext) -> None:
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            rules: Set[str] = {r.strip() for r in m.group(1).split(",")}
            reason = m.group(2).strip()
            line = tok.start[0]
            if not reason:
                ctx.bad_suppressions.append(line)
                continue
            ctx.suppressions.setdefault(line, set()).update(rules)
    except tokenize.TokenError:
        pass


def lint_source(source: str, path: str) -> List[Diagnostic]:
    """Lint one file's source text; ``path`` anchors the diagnostics."""
    ctx = FileContext(path=path, source=source)
    _collect_suppressions(source, ctx)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [diag("LINT-SUPPRESS", f"{path}:{e.lineno or 1}",
                     f"file does not parse: {e.msg}",
                     hint="fix the syntax error",
                     severity=None)]
    out: List[Diagnostic] = []
    for rule in ALL_RULES:
        out.extend(rule(tree, ctx))
    for line in ctx.bad_suppressions:
        out.append(diag(
            "LINT-SUPPRESS", f"{path}:{line}",
            "suppression comment without a justifying reason",
            hint="write the why after the bracket: "
                 "# lint: ignore[RULE-ID] <reason>"))
    return out


def lint_file(filename: str, repo_root: str = ".") -> List[Diagnostic]:
    rel = os.path.relpath(filename, repo_root)
    with open(filename, "r", encoding="utf-8") as f:
        return lint_source(f.read(), rel)


def iter_py_files(root: str) -> Iterable[str]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", ".git"))
        for name in sorted(filenames):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def lint_tree(root: str, repo_root: str = ".") -> List[Diagnostic]:
    """Lint every ``.py`` under ``root``, or the file ``root`` (the CI
    entry point walks ``src/repro_torch`` and ``chip_smoke.py``)."""
    if os.path.isfile(root):
        return lint_file(root, repo_root)
    out: List[Diagnostic] = []
    for path in iter_py_files(root):
        out.extend(lint_file(path, repo_root))
    return out
