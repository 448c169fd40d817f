"""R2 — recompile-hazard.

The executor cache keys executors by ``(bucket, slots, cache_variant())``.
Anything the builder (``build_executor``) reads off ``self`` but does
*not* fold into ``cache_variant()`` is an invisible cache dimension: two
planners differing only in that attribute share a cache row, and the
second silently reuses the first's executor (a mesh's executor on a
mesh-less session, or one device's on another).

The static half of this rule: for every class that defines both a
``cache_variant``-style key method and a ``build_*`` builder, every
``self.<attr>`` the builder reads must also be read by the key method,
either directly or through a ``self._<attr>_key`` alias (unhashable
objects like the slot mesh ride in the key as a precomputed hashable
fold).  Method calls on ``self`` are not attribute closures and are
exempt.

The runtime half lives in :mod:`repro_torch.analysis.sentinel`: a compile
event listener asserting no kernel build and no executor build on the
warm path.
"""

from __future__ import annotations

import ast

from .engine import AnalysisContext, Finding, SourceFile

RULE = "R2"

_KEY_METHODS = {"cache_variant", "variant_key"}
_BUILDER_PREFIX = "build_"


def _self_attr_reads(fn: ast.AST) -> set[str]:
    """Names X for every ``self.X`` load inside ``fn``."""
    reads: set[str] = set()
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            reads.add(node.attr)
    return reads


def _check_class(sf: SourceFile, cls: ast.ClassDef) -> list[Finding]:
    methods = {
        n.name: n
        for n in cls.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    key_fn = next((methods[m] for m in _KEY_METHODS if m in methods), None)
    builders = [
        fn
        for name, fn in methods.items()
        if name.startswith(_BUILDER_PREFIX) and fn is not key_fn
    ]
    if key_fn is None or not builders:
        return []

    key_reads = _self_attr_reads(key_fn)
    findings: list[Finding] = []
    for builder in builders:
        for attr in sorted(_self_attr_reads(builder)):
            if attr in methods:  # self.method(...) is not a closure
                continue
            alias = f"_{attr.lstrip('_')}_key"
            if attr in key_reads or alias in key_reads:
                continue
            # Anchor on the first read of the attribute in the builder.
            line = min(
                node.lineno
                for node in ast.walk(builder)
                if isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and node.attr == attr
            )
            findings.append(
                Finding(
                    rule=RULE,
                    path=sf.rel,
                    line=line,
                    scope=f"{cls.name}.{builder.name}",
                    message=(
                        f"builder closes over self.{attr} but "
                        f"{key_fn.name}() does not fold it (or a "
                        f"self.{alias} alias) into the compile-cache "
                        "variant key — recompile hazard"
                    ),
                    snippet=sf.line_text(line),
                )
            )
    return findings


def check(ctx: AnalysisContext) -> list[Finding]:
    findings: list[Finding] = []
    for rel in ctx.config.recompile_files:
        sf = ctx.get(rel)
        if sf is None:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(_check_class(sf, node))
    return findings
