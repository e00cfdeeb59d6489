"""The port's invariant lint: `python -m repro_torch.analysis.lint
src/repro_torch [...]`.

Port copy of :mod:`repro.analysis.lint`. Walks the given files/directories,
runs the port's rules from `repro_torch.analysis.rules` (RPR001, RPR003,
RPR004, RPR006; RPR002 and RPR005 have no torch meaning, see that module)
on every `*.py` file, applies suppression comments, prints findings as
`path:line:col: RULE message`, and exits non-zero when anything fires.

File tags (standalone comments, conventionally near the top):

    # repro: hot-path      enables RPR001 for the file
    # repro: gauge-path    enables RPR003 for the file

Suppression:

    # repro: allow[RPR001] harvest is THE designed sync point

An allow comment suppresses the named rule on its own line, on the line
directly below it (for comment-only lines), or — when it sits on a
`def`/`class` line — on every line of that definition's body.  The
justification string is REQUIRED: a bare `# repro: allow[RPR001]`
suppresses nothing and itself raises RPR006.
"""
from __future__ import annotations

import argparse
import ast
import re
import sys
from pathlib import Path

from repro_torch.analysis.rules import ALL_CHECKS, RULES, Finding

_TAG_RE = re.compile(r"#\s*repro:\s*(hot-path|gauge-path)\b")
_ALLOW_RE = re.compile(r"#\s*repro:\s*allow\[([A-Z]{3}\d{3})\]\s*(.*)$")


def _parse_tags(lines: list[str]) -> set[str]:
    tags: set[str] = set()
    for line in lines:
        m = _TAG_RE.search(line)
        if m:
            tags.add(m.group(1))
    return tags


def _parse_allows(path: str, lines: list[str], tree: ast.AST):
    """Return (allowed: {(line, rule)}, findings: [RPR006 Finding])."""
    # def/class lines -> full body span, so an allow on a definition line
    # covers the whole definition (used for cold-path helpers whose every
    # host transfer is intended).
    def_spans: dict[int, range] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            end = getattr(node, "end_lineno", node.lineno)
            def_spans[node.lineno] = range(node.lineno, end + 1)

    allowed: set[tuple[int, str]] = set()
    findings: list[Finding] = []
    for lineno, line in enumerate(lines, 1):
        m = _ALLOW_RE.search(line)
        if not m:
            continue
        rule, why = m.group(1), m.group(2).strip()
        if not why:
            findings.append(Finding(
                path, lineno, line.index("#"), "RPR006",
                f"allow[{rule}] without a justification (required; "
                "the bare allow suppresses nothing)"))
            continue
        if rule not in RULES:
            findings.append(Finding(
                path, lineno, line.index("#"), "RPR006",
                f"allow[{rule}] names an unknown rule "
                f"(known: {', '.join(sorted(RULES))})"))
            continue
        # the allow covers its own line; a comment-only allow attaches to
        # the next code line (skipping continuation comment lines), and
        # when that target is a def/class line it covers the whole body
        allowed.add((lineno, rule))
        target = lineno
        if lines[lineno - 1].lstrip().startswith("#"):
            target = lineno + 1
            while (target <= len(lines)
                   and lines[target - 1].lstrip().startswith("#")):
                target += 1
        span = def_spans.get(target) or def_spans.get(lineno)
        if span is not None:
            for covered in span:
                allowed.add((covered, rule))
        else:
            allowed.add((target, rule))
    return allowed, findings


def lint_file(path: str | Path, source: str | None = None) -> list[Finding]:
    path = str(path)
    if source is None:
        source = Path(path).read_text()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Finding(path, exc.lineno or 1, exc.offset or 0, "RPR000",
                        f"syntax error: {exc.msg}")]
    lines = source.splitlines()
    tags = _parse_tags(lines)
    allowed, findings = _parse_allows(path, lines, tree)
    for check in ALL_CHECKS:
        for f in check(path, tree, lines, tags):
            if (f.line, f.rule) not in allowed:
                findings.append(f)
    return sorted(findings, key=lambda f: (f.line, f.col, f.rule))


def _iter_py_files(targets: list[str]):
    for target in targets:
        p = Path(target)
        if p.is_dir():
            yield from sorted(p.rglob("*.py"))
        elif p.suffix == ".py":
            yield p
        else:
            raise SystemExit(f"lint: not a python file or directory: {target}")


def lint_paths(targets: list[str]) -> list[Finding]:
    findings: list[Finding] = []
    for path in _iter_py_files(targets):
        findings.extend(lint_file(path))
    return findings


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="the port's invariant lint (RPR001, RPR003, RPR004, "
                    "RPR006)")
    ap.add_argument("targets", nargs="*", help="files or directories")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0
    if not args.targets:
        ap.error("the following arguments are required: targets")
    findings = lint_paths(args.targets)
    for f in findings:
        print(f.render())
    if findings:
        print(f"{len(findings)} finding(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
