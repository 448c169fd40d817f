"""R6 — wire-schema safety.

Errors cross the wire as ``{type, message, context}`` and are re-raised
typed on the client (:func:`repro_torch.serve.wire.raise_remote_error`).  That
only stays true while three invariants hold, and each is a drift
magnet:

* **Whitelist is live.** Every name in ``wire._ERROR_CONTEXT`` is an
  actual constructor parameter or attribute of some ``repro_torch.errors``
  class — a stale entry silently stops carrying context.
* **Whitelist is complete.** Every scalar-annotated (``int``/``float``/
  ``str``/``bool``) constructor parameter of every error class is either
  whitelisted or listed in ``wire._ERROR_CONTEXT_EXCLUDED`` with a
  written reason — a forgotten field means typed context evaporates at
  the first socket.
* **Re-raisable by name.** Every class in ``repro_torch.errors.__all__`` is
  constructible from a bare message (first parameter positional, every
  other parameter defaulted), because ``raise_remote_error`` degrades to
  ``cls(msg)`` when a peer sends no context.
"""

from __future__ import annotations

import ast

from .engine import AnalysisContext, Finding, SourceFile, const_str

RULE = "R6"

_SCALARS = {"int", "float", "str", "bool"}


def _tuple_of_strs(sf: SourceFile, name: str) -> tuple[set[str], int]:
    for node in ast.walk(sf.tree):
        targets: list[ast.expr] = []
        value: ast.expr | None = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        for t in targets:
            if isinstance(t, ast.Name) and t.id == name:
                vals = {
                    s
                    for elt in getattr(value, "elts", [])
                    if (s := const_str(elt)) is not None
                }
                return vals, node.lineno
    return set(), 1


def _is_scalar_annotation(ann: ast.AST | None) -> bool:
    if ann is None:
        return False
    try:
        text = ast.unparse(ann)
    except Exception:
        return False
    text = text.replace("Optional[", "").replace("]", "")
    parts = [p.strip() for p in text.split("|")]
    parts = [p for p in parts if p and p != "None"]
    return bool(parts) and all(p in _SCALARS for p in parts)


def _error_classes(sf: SourceFile) -> dict[str, ast.ClassDef]:
    exported, _ = _tuple_of_strs(sf, "__all__")
    classes: dict[str, ast.ClassDef] = {}
    for node in sf.tree.body:
        if isinstance(node, ast.ClassDef) and (
            not exported or node.name in exported
        ):
            classes[node.name] = node
    return classes


def _init_of(cls: ast.ClassDef) -> ast.FunctionDef | None:
    for node in cls.body:
        if isinstance(node, ast.FunctionDef) and node.name == "__init__":
            return node
    return None


def check(ctx: AnalysisContext) -> list[Finding]:
    wire_sf = ctx.get(ctx.config.wire_file)
    errors_sf = ctx.get(ctx.config.errors_file)
    if wire_sf is None or errors_sf is None:
        return []

    whitelist, wl_line = _tuple_of_strs(wire_sf, "_ERROR_CONTEXT")
    excluded, _ = _tuple_of_strs(wire_sf, "_ERROR_CONTEXT_EXCLUDED")
    classes = _error_classes(errors_sf)

    findings: list[Finding] = []

    # Collect params/attrs across the taxonomy.
    known_names: set[str] = set()
    scalar_params: dict[str, tuple[str, int]] = {}  # name -> (class, line)
    for cname, cls in classes.items():
        init = _init_of(cls)
        if init is None:
            continue
        params = [*init.args.posonlyargs, *init.args.args, *init.args.kwonlyargs]
        for p in params[1:]:  # drop self
            known_names.add(p.arg)
            if _is_scalar_annotation(p.annotation) and p.arg not in scalar_params:
                scalar_params[p.arg] = (cname, p.lineno)
        for node in ast.walk(init):
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
            ):
                known_names.add(node.attr)

    # 1. whitelist entries must be live.
    for name in sorted(whitelist):
        if name not in known_names:
            findings.append(
                Finding(
                    rule=RULE,
                    path=wire_sf.rel,
                    line=wl_line,
                    scope="<module>",
                    message=(
                        f"_ERROR_CONTEXT entry {name!r} matches no parameter "
                        "or attribute of any repro_torch.errors class (stale — "
                        "carries nothing)"
                    ),
                    snippet=f"context:{name}",
                )
            )

    # 2. scalar params must be whitelisted or explicitly excluded.
    for name, (cname, line) in sorted(scalar_params.items()):
        if name in whitelist or name in excluded or name == "message":
            continue
        findings.append(
            Finding(
                rule=RULE,
                path=errors_sf.rel,
                line=line,
                scope=f"{cname}.__init__",
                message=(
                    f"scalar error-context param {name!r} is neither in "
                    "wire._ERROR_CONTEXT nor wire._ERROR_CONTEXT_EXCLUDED "
                    "(context silently dropped at the wire)"
                ),
                snippet=f"param:{name}",
            )
        )

    # 3. every exported class must be message-only constructible.
    for cname, cls in sorted(classes.items()):
        init = _init_of(cls)
        if init is None:
            continue  # inherits a compliant __init__
        args = init.args
        positional = [*args.posonlyargs, *args.args][1:]  # drop self
        ok = True
        n_defaults = len(args.defaults)
        # all but the first positional (message) need defaults
        if len(positional) - n_defaults > 1:
            ok = False
        if sum(1 for d in args.kw_defaults if d is None) > 0:
            ok = False
        if not ok:
            findings.append(
                Finding(
                    rule=RULE,
                    path=errors_sf.rel,
                    line=init.lineno,
                    scope=f"{cname}.__init__",
                    message=(
                        f"{cname} is not constructible from a bare message "
                        "(raise_remote_error's degraded path would fail)"
                    ),
                    snippet=errors_sf.line_text(init.lineno),
                )
            )
    return findings
