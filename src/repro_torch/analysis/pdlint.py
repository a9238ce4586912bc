"""pdlint CLI — run the concurrency-contract rules over source trees.

Usage::

    python -m repro_torch.analysis.pdlint src/repro_torch/core [more paths...]
    python -m repro_torch.analysis.pdlint --list-rules
    python -m repro_torch.analysis.pdlint --select PD-L002,PD-L005 src/repro_torch/core

Exit codes: 0 clean, 1 unsuppressed findings, 2 usage/parse error.
``--markdown FILE`` appends a findings table (GitHub step-summary shape).
Suppress a finding with a ``# pdlint: disable=PD-Lxxx`` comment on (or
immediately above) the flagged line.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from .model import Finding, Project, build_project
from .rules import list_rules, make_rules

EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_ERROR = 2


def run(
    paths: Sequence[Path], select: Optional[Sequence[str]] = None
) -> Tuple[List[Finding], Project]:
    """Analyze ``paths``; returns (unsuppressed findings, project)."""
    project = build_project([Path(p) for p in paths])
    findings: List[Finding] = []
    for rule in make_rules(select):
        if rule.scope == "project":
            findings.extend(rule.check_project(project))
        else:
            for module in project.modules:
                findings.extend(rule.check_module(project, module))
    kept = []
    for f in findings:
        module = project.module_for(f.path)
        if module is not None and module.suppressed(f.line, f.rule):
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return kept, project


def _markdown_table(findings: Sequence[Finding], errors: Sequence[str]) -> str:
    lines = ["## pdlint — concurrency contracts", ""]
    if not findings and not errors:
        lines.append("No findings: every contract holds.")
        return "\n".join(lines) + "\n"
    if findings:
        lines += [
            f"{len(findings)} finding(s):",
            "",
            "| rule | location | message | hint |",
            "| --- | --- | --- | --- |",
        ]
        for f in findings:
            msg = f.message.replace("|", "\\|")
            hint = f.hint.replace("|", "\\|")
            lines.append(f"| {f.rule} | `{f.path}:{f.line}` | {msg} | {hint} |")
    for err in errors:
        lines.append(f"- parse error: `{err}`")
    return "\n".join(lines) + "\n"


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="pdlint",
        description="concurrency-contract static analyzer for the "
        "coordination plane",
    )
    parser.add_argument("paths", nargs="*", help="files or directories")
    parser.add_argument(
        "--select",
        help="comma-separated rule ids to run (default: all)",
    )
    parser.add_argument(
        "--markdown",
        metavar="FILE",
        help="append a findings table to FILE (CI step summary)",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print rule ids and exit"
    )
    args = parser.parse_args(argv)
    if args.list_rules:
        for rule_id in list_rules():
            print(rule_id)
        return EXIT_CLEAN
    if not args.paths:
        print("pdlint: no paths given (try src/repro_torch/core)", file=sys.stderr)
        return EXIT_ERROR
    paths = [Path(p) for p in args.paths]
    for p in paths:
        if not p.exists():
            print(f"pdlint: path does not exist: {p}", file=sys.stderr)
            return EXIT_ERROR
    select = None
    if args.select:
        select = [s.strip() for s in args.select.split(",") if s.strip()]
    try:
        findings, project = run(paths, select)
    except KeyError as exc:
        print(f"pdlint: {exc}", file=sys.stderr)
        return EXIT_ERROR
    for f in findings:
        print(f.format())
    for err in project.errors:
        print(f"pdlint: parse error: {err}", file=sys.stderr)
    if args.markdown:
        with open(args.markdown, "a", encoding="utf-8") as fh:
            fh.write(_markdown_table(findings, project.errors))
    if project.errors:
        return EXIT_ERROR
    if findings:
        print(
            f"pdlint: {len(findings)} finding(s) "
            f"(suppress with '# pdlint: disable=<rule>')",
            file=sys.stderr,
        )
        return EXIT_FINDINGS
    return EXIT_CLEAN


if __name__ == "__main__":
    sys.exit(main())
