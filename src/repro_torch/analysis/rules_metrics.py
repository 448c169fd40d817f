"""R5 — metric-name drift.

Metrics are stringly-typed at every call site, so a renamed or typo'd
counter fails *open*: the writer happily creates a fresh series and the
dashboard/test reading the old name sees zeros forever.  This rule
closes the loop against the declared registry
(:mod:`repro_torch.obs.names`): every string-literal metric name passed
to an ``inc`` / ``observe`` / ``set_gauge`` / ``value`` / ``gauge_value``
/ ``histogram`` call — in the port, its tests and ``chip_smoke.py`` —
must be declared,
and so must every key of a dict literal passed to ``ingest``.

Dynamic names (variables, f-strings) are skipped; the rule checks what
it can prove, not what it can guess.
"""

from __future__ import annotations

import ast

from .engine import (
    AnalysisContext,
    Finding,
    SourceFile,
    build_parents,
    const_str,
    scope_of,
)

RULE = "R5"

_NAME_CALLS = {
    "inc",
    "observe",
    "set_gauge",
    "value",
    "gauge_value",
    "histogram",
}
_INGEST_CALLS = {"ingest"}
_DECL_NAMES = {"COUNTERS", "GAUGES", "HISTOGRAMS"}


def _declared(sf: SourceFile) -> set[str]:
    declared: set[str] = set()
    for node in ast.walk(sf.tree):
        targets: list[ast.expr] = []
        value: ast.expr | None = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        if not any(
            isinstance(t, ast.Name) and t.id in _DECL_NAMES for t in targets
        ):
            continue
        for sub in ast.walk(value):
            s = const_str(sub)
            if s is not None:
                declared.add(s)
    return declared


def _check_file(sf: SourceFile, declared: set[str]) -> list[Finding]:
    findings: list[Finding] = []
    parents = build_parents(sf.tree)

    def emit(node: ast.AST, name: str, via: str) -> None:
        findings.append(
            Finding(
                rule=RULE,
                path=sf.rel,
                line=node.lineno,
                scope=scope_of(node, parents),
                message=(
                    f"metric name {name!r} (via .{via}) is not declared in "
                    "repro_torch.obs.names — drift between writer and reader"
                ),
                snippet=sf.line_text(node.lineno),
            )
        )

    for node in ast.walk(sf.tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        attr = node.func.attr
        if attr in _NAME_CALLS and node.args:
            name = const_str(node.args[0])
            if name is not None and name not in declared:
                emit(node, name, attr)
        elif attr in _INGEST_CALLS and node.args:
            payload = node.args[0]
            if isinstance(payload, ast.Dict):
                for key in payload.keys:
                    name = const_str(key) if key is not None else None
                    if name is not None and name not in declared:
                        emit(key, name, attr)
    return findings


def check(ctx: AnalysisContext) -> list[Finding]:
    names_sf = ctx.get(ctx.config.names_file)
    if names_sf is None:
        return [
            Finding(
                rule=RULE,
                path=ctx.config.names_file,
                line=1,
                scope="<module>",
                message="metric-name registry file is missing",
                snippet="",
            )
        ]
    declared = _declared(names_sf)
    if not declared:
        return [
            Finding(
                rule=RULE,
                path=names_sf.rel,
                line=1,
                scope="<module>",
                message="metric-name registry declares no names",
                snippet=names_sf.line_text(1),
            )
        ]
    findings: list[Finding] = []
    for rel in ctx.config.metric_ref_files:
        sf = ctx.get(rel)
        if sf is not None and rel != ctx.config.names_file:
            findings.extend(_check_file(sf, declared))
    return findings
