"""Structured diagnostics shared by the artifact verifier and the AST lint
(a copy of ``repro.analysis.diagnostics``; the port imports nothing of the
reference).

A check never asserts: it returns :class:`Diagnostic` records carrying the
rule id, severity, the artifact/file path the finding anchors to, a
one-line message, and a fix hint.  Call sites decide what a finding means
— pack time raises on errors in ``strict=`` mode, admission gates reject
the checkpoint, the CLI renders everything and exits non-zero on errors.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Iterable, Optional, Sequence


class Severity(enum.IntEnum):
    """Ordered so ``max(severities)`` is the run's overall verdict."""
    NOTE = 0
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:  # noqa: DunderStr - render tag
        return self.name.lower()


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding.

    ``path`` is where the finding anchors: a file (``src/...py:LINE``) for
    lint rules, a dotted artifact path (``zoo/VGGNet/layer3/packed``) for
    the verifier.  ``hint`` says how to fix it, not just what broke.
    """
    rule: str
    severity: Severity
    path: str
    message: str
    hint: str = ""

    def render(self) -> str:
        s = f"{self.path}: {self.severity}: [{self.rule}] {self.message}"
        if self.hint:
            s += f" (fix: {self.hint})"
        return s


@dataclasses.dataclass(frozen=True)
class RuleInfo:
    """Registry entry: what a rule proves and where it runs."""
    rule: str
    severity: Severity
    summary: str
    stage: str                  # "pack" | "admission" | "ci" | "pack+ci" ...


#: Every rule either half can emit, in registration order.  The CLI
#: ``--rules`` listing renders from here, so the docs cannot drift from the
#: code.
REGISTRY: Dict[str, RuleInfo] = {}


def register(rule: str, severity: Severity, summary: str,
             stage: str) -> str:
    if rule in REGISTRY:
        raise ValueError(f"duplicate rule id {rule!r}")
    REGISTRY[rule] = RuleInfo(rule, severity, summary, stage)
    return rule


def diag(rule: str, path: str, message: str, *,
         hint: Optional[str] = None,
         severity: Optional[Severity] = None) -> Diagnostic:
    """Build a Diagnostic for a registered rule (registry supplies the
    default severity and keeps unknown rule ids out of reports)."""
    info = REGISTRY[rule]
    return Diagnostic(rule, severity if severity is not None
                      else info.severity, path, message,
                      hint if hint is not None else "")


def has_errors(diags: Iterable[Diagnostic]) -> bool:
    return any(d.severity >= Severity.ERROR for d in diags)


class AnalysisError(ValueError):
    """Raised by strict pack/admission gates when the verifier finds
    errors; carries the diagnostics so callers can render them."""

    def __init__(self, diags: Sequence[Diagnostic], context: str = ""):
        self.diags = list(diags)
        errs = [d for d in self.diags if d.severity >= Severity.ERROR]
        head = f"{context}: " if context else ""
        lines = "\n".join("  " + d.render() for d in errs)
        super().__init__(
            f"{head}{len(errs)} artifact invariant violation(s)\n{lines}")


def render_text(diags: Sequence[Diagnostic]) -> str:
    """Plain-text report, errors first."""
    order = sorted(diags, key=lambda d: (-int(d.severity), d.rule, d.path))
    lines = [d.render() for d in order]
    n_err = sum(d.severity >= Severity.ERROR for d in diags)
    n_warn = sum(d.severity == Severity.WARNING for d in diags)
    lines.append(f"{len(diags)} finding(s): {n_err} error(s), "
                 f"{n_warn} warning(s)")
    return "\n".join(lines)


def render_github(diags: Sequence[Diagnostic],
                  title: str = "repro_torch.analysis") -> str:
    """Markdown table for the CI job summary ($GITHUB_STEP_SUMMARY)."""
    lines = [f"## {title}", ""]
    if not diags:
        lines.append("No findings — all invariants hold.")
        return "\n".join(lines)
    lines += ["| severity | rule | where | finding |",
              "| --- | --- | --- | --- |"]
    for d in sorted(diags, key=lambda d: (-int(d.severity), d.rule, d.path)):
        msg = d.message + (f" — *{d.hint}*" if d.hint else "")
        msg = msg.replace("|", "\\|")
        lines.append(f"| {d.severity} | `{d.rule}` | `{d.path}` | {msg} |")
    n_err = sum(d.severity >= Severity.ERROR for d in diags)
    lines += ["", f"**{len(diags)} finding(s), {n_err} error(s).**"]
    return "\n".join(lines)


def raise_on_errors(diags: Sequence[Diagnostic], context: str = "") -> None:
    """The strict-mode gate: raise :class:`AnalysisError` if any finding is
    an error; warnings and notes pass silently."""
    if has_errors(diags):
        raise AnalysisError(diags, context)
