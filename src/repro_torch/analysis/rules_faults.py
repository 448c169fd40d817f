"""R4 — fault-site coverage.

Fault injection only means anything if the site names line up end to
end: an ``inject("dispatch_", ...)`` typo is a fault that never fires,
and a declared site no test exercises is a recovery path that has never
run.  Two checks:

* every string literal passed to ``inject(...)`` (positionally or as
  ``site=``) anywhere in the scanned files must be a member of
  ``repro_torch.resilience.faults.FAULT_SITES``;
* every member of ``FAULT_SITES`` must appear, as a string literal, in
  at least one test file.
"""

from __future__ import annotations

import ast

from .engine import (
    AnalysisContext,
    Finding,
    SourceFile,
    build_parents,
    call_name,
    const_str,
    scope_of,
)

RULE = "R4"

_SITES_NAME = "FAULT_SITES"


def _declared_sites(sf: SourceFile) -> tuple[set[str], int, int]:
    """(site names, first line, last line) of ``FAULT_SITES = (...)``."""
    for node in ast.walk(sf.tree):
        targets: list[ast.expr] = []
        value: ast.expr | None = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        for t in targets:
            if isinstance(t, ast.Name) and t.id == _SITES_NAME:
                sites = {
                    s
                    for elt in getattr(value, "elts", [])
                    if (s := const_str(elt)) is not None
                }
                return sites, node.lineno, node.end_lineno or node.lineno
    return set(), 1, 1


def _inject_site_literals(sf: SourceFile) -> list[tuple[str, int, str]]:
    """(site, line, scope) for every literal-site ``inject`` call."""
    parents = build_parents(sf.tree)
    out: list[tuple[str, int, str]] = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if name is None or name.split(".")[-1] != "inject":
            continue
        site_expr: ast.AST | None = node.args[0] if node.args else None
        for kw in node.keywords:
            if kw.arg == "site":
                site_expr = kw.value
        site = const_str(site_expr) if site_expr is not None else None
        if site is not None:
            out.append((site, node.lineno, scope_of(node, parents)))
    return out


def check(ctx: AnalysisContext) -> list[Finding]:
    faults_sf = ctx.get(ctx.config.faults_file)
    if faults_sf is None:
        return []
    sites, decl_line, decl_end = _declared_sites(faults_sf)
    if not sites:
        return [
            Finding(
                rule=RULE,
                path=faults_sf.rel,
                line=decl_line,
                scope="<module>",
                message=f"{_SITES_NAME} declaration not found or empty",
                snippet=faults_sf.line_text(decl_line),
            )
        ]

    findings: list[Finding] = []
    for rel, sf in ctx.files.items():
        for site, line, scope in _inject_site_literals(sf):
            if site not in sites:
                findings.append(
                    Finding(
                        rule=RULE,
                        path=rel,
                        line=line,
                        scope=scope,
                        message=(
                            f"inject() site {site!r} is not declared in "
                            f"{_SITES_NAME} (the fault can never be armed)"
                        ),
                        snippet=sf.line_text(line),
                    )
                )

    covered: set[str] = set()
    for sf in ctx.test_sources():
        for node in ast.walk(sf.tree):
            s = const_str(node)
            if s not in sites:
                continue
            # the declaration itself is not coverage (matters when the
            # faults file doubles as a test file, as in the fixtures)
            if sf.rel == faults_sf.rel and decl_line <= node.lineno <= decl_end:
                continue
            covered.add(s)
    for site in sorted(sites - covered):
        findings.append(
            Finding(
                rule=RULE,
                path=faults_sf.rel,
                line=decl_line,
                scope="<module>",
                message=(
                    f"fault site {site!r} is declared but no test references "
                    "it (untested recovery path)"
                ),
                snippet=f"site:{site}",
            )
        )
    return findings
