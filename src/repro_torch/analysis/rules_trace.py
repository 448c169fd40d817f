"""R1 — host syncs on the hot path.

The port's peel runs its trips as Python loops of device operations, so
the invariant the reference states for traced code ("no host round trip
inside jit") becomes: no device→host readback in the card's hot path
except the counted ones.  Two sub-checks:

**Hot-path purity.** In the configured hot-path files, every function
(but the scopes the configuration marks off the card's path: the
kernels' plain versions and diagnostics) must not:

* call ``.item()``, ``.tolist()``, ``.numpy()`` or ``.cpu()`` on a tensor,
  or ``.cpu()`` on anything;
* coerce a tensor with ``bool()``/``int()``/``float()``/``complex()``,
  or branch (``if``/``while``) on one (an implicit ``bool()``);
* hand a tensor to ``np.asarray``/``np.array``/``np.copy``;
* call ``torch.cuda.synchronize()`` or any ``.synchronize()``.

What is a tensor is decided from the source, conservatively: parameters
and annotated locals whose annotation names ``Tensor``, ``FineProblem``,
``PeelState`` or ``Worklist``; names assigned (after that statement) from
``torch.*`` calls, from tensor expressions, or from calls of this file's
functions and methods whose return annotation names one of those types.
Shape metadata (``.shape``, ``.dtype``, ``.device``, ``.numel()``, a
problem's ``.n``/``.nnz_pad``, ...) is static and exempt, and so is
anything inside a ``raise`` statement (an error message's readback runs
once, on the way out).  A counted readback — the peel's per-trip
``done`` test, the fused loop's per-level one — carries
``# trusslint: disable=R1`` with its reason on the line above.

**Dispatch-path readback.** In the configured dispatch files, flag a
readback (the calls above, or a coercion) of a packed tensor (an
expression through ``.problem``) *before* the first ``.peel(`` call in
the same function: a host sync there stalls the dispatch before the first
launch.  Readbacks after dispatch are how results come home and are fine.
"""

from __future__ import annotations

import ast

from .engine import (
    AnalysisContext,
    Finding,
    SourceFile,
    build_parents,
    call_name,
    dotted_name,
    scope_of,
)

RULE = "R1"

_TENSOR_MARKERS = ("Tensor", "FineProblem", "PeelState", "Worklist")
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout", "n", "nnz_pad"}
_STATIC_METHODS = {
    "numel", "dim", "size", "element_size", "nelement", "stride", "data_ptr",
    "is_contiguous", "get_device",
}
_SYNC_METHODS = {"item", "tolist", "numpy", "cpu"}
_COERCIONS = {"bool", "int", "float", "complex"}
_NP_READBACKS = {"np.asarray", "np.array", "np.copy", "numpy.asarray", "numpy.array"}
# torch.* calls that return no tensor.
_TORCH_HOST = {
    "torch.device", "torch.is_tensor", "torch.iinfo", "torch.finfo", "torch.Size",
    "torch.get_default_dtype", "torch.cuda.is_available", "torch.cuda.device_count",
    "torch.cuda.current_device", "torch.cuda.device", "torch.cuda.stream",
    "torch.cuda.current_stream", "torch.cuda.synchronize",
    "torch.cuda.is_current_stream_capturing",
}


def _marked(ann: ast.AST | None) -> bool:
    if ann is None:
        return False
    try:
        text = ast.unparse(ann)
    except Exception:
        return False
    return any(m in text for m in _TENSOR_MARKERS)


def _tensor_returning(tree: ast.AST) -> tuple[set[str], dict[tuple[str, str], bool]]:
    """(module functions, {(class, method)}) whose return annotation names
    a tensor type."""
    funcs: set[str] = set()
    methods: dict[tuple[str, str], bool] = {}
    for node in getattr(tree, "body", []):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _marked(node.returns):
            funcs.add(node.name)
        elif isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and _marked(m.returns):
                    methods[(node.name, m.name)] = True
    return funcs, methods


class _Typer:
    """Which expressions of one function are tensors (see the module doc)."""

    def __init__(self, fn, cls: str | None, funcs, methods, outer: dict[str, int]):
        self.cls = cls
        self.funcs = funcs
        self.methods = methods
        # name -> the last line of the statement after which it is a tensor.
        self.since: dict[str, int] = dict(outer)
        args = fn.args
        for a in [*args.posonlyargs, *args.args, *args.kwonlyargs]:
            if _marked(a.annotation):
                self.since[a.arg] = 0
        stmts = [n for n in _own_nodes(fn) if isinstance(n, (ast.Assign, ast.AnnAssign))]
        stmts.sort(key=lambda n: n.lineno)
        changed = True
        while changed:
            changed = False
            for st in stmts:
                end = st.end_lineno or st.lineno
                if isinstance(st, ast.AnnAssign):
                    targets = [st.target]
                    tensor = _marked(st.annotation) or (
                        st.value is not None and self.is_tensor(st.value)
                    )
                else:
                    targets = st.targets
                    tensor = self.is_tensor(st.value)
                if not tensor:
                    continue
                for t in targets:
                    for name in _target_names(t):
                        if self.since.get(name, 1 << 30) > end:
                            self.since[name] = end
                            changed = True

    def is_tensor(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.since and e.lineno > self.since[e.id]
        if isinstance(e, ast.Attribute):
            if e.attr in _STATIC_ATTRS:
                return False
            return self.is_tensor(e.value)
        if isinstance(e, ast.Subscript):
            return self.is_tensor(e.value)
        if isinstance(e, ast.Call):
            f = e.func
            if isinstance(f, ast.Name):
                return f.id in _TENSOR_MARKERS or f.id in self.funcs
            if isinstance(f, ast.Attribute):
                if f.attr in _STATIC_METHODS or f.attr in _SYNC_METHODS:
                    return False
                name = dotted_name(f)
                if name is not None and name.startswith("torch."):
                    return name not in _TORCH_HOST
                if isinstance(f.value, ast.Name) and f.value.id == "self":
                    return (self.cls, f.attr) in self.methods
                return self.is_tensor(f.value)
            return False
        if isinstance(e, ast.BinOp):
            return self.is_tensor(e.left) or self.is_tensor(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.is_tensor(e.operand)
        if isinstance(e, ast.BoolOp):
            return any(self.is_tensor(v) for v in e.values)
        if isinstance(e, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in e.ops):
                return False
            return any(self.is_tensor(x) for x in [e.left, *e.comparators])
        if isinstance(e, ast.IfExp):
            return self.is_tensor(e.body) or self.is_tensor(e.orelse)
        return False


def _target_names(t: ast.AST) -> list[str]:
    if isinstance(t, ast.Name):
        return [t.id]
    if isinstance(t, (ast.Tuple, ast.List)):
        return [n for elt in t.elts for n in _target_names(elt)]
    return []


def _own_nodes(fn: ast.AST):
    """Nodes of ``fn``'s body, not descending into nested functions/classes."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _in_raise(node: ast.AST, parents: dict[ast.AST, ast.AST]) -> bool:
    cur = parents.get(node)
    while cur is not None and not isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
        if isinstance(cur, ast.Raise):
            return True
        cur = parents.get(cur)
    return False


def _check_function(
    sf: SourceFile, fn, typer: _Typer, parents: dict[ast.AST, ast.AST]
) -> list[Finding]:
    findings: list[Finding] = []
    scope = scope_of(fn, parents)

    def emit(node: ast.AST, message: str) -> None:
        findings.append(
            Finding(
                rule=RULE,
                path=sf.rel,
                line=node.lineno,
                scope=scope,
                message=message,
                snippet=sf.line_text(node.lineno),
            )
        )

    for node in _own_nodes(fn):
        if _in_raise(node, parents):
            continue
        if isinstance(node, ast.Call):
            name = call_name(node)
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "synchronize":
                emit(node, f"{name or '.synchronize'}() blocks the host on the device")
            elif isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS and (
                f.attr == "cpu" or typer.is_tensor(f.value)
            ):
                emit(node, f".{f.attr}() reads a tensor back to the host (a device sync)")
            elif name in _COERCIONS and node.args and typer.is_tensor(node.args[0]):
                emit(node, f"{name}() of a tensor reads it back to the host (a device sync)")
            elif name in _NP_READBACKS and node.args and typer.is_tensor(node.args[0]):
                emit(node, f"{name}() of a tensor reads it back to the host (a device sync)")
        elif isinstance(node, (ast.If, ast.While)) and typer.is_tensor(node.test):
            kind = "if" if isinstance(node, ast.If) else "while"
            emit(node, f"Python `{kind}` on a tensor (an implicit bool() readback)")
    return findings


def _functions(tree: ast.AST):
    """(function, enclosing class name or None, enclosing function or None)."""
    out = []

    def walk(node, cls, outer):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                walk(child, child.name, outer)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((child, cls, outer))
                walk(child, None, child)
            else:
                walk(child, cls, outer)

    walk(tree, None, None)
    return out


def _check_hot_file(sf: SourceFile, off_path: set[str]) -> list[Finding]:
    parents = build_parents(sf.tree)
    funcs, methods = _tensor_returning(sf.tree)
    typers: dict[ast.AST, _Typer] = {}
    findings: list[Finding] = []
    for fn, cls, outer in _functions(sf.tree):
        scope = scope_of(fn, parents)
        outer_names = typers[outer].since if outer in typers else {}
        typer = typers[fn] = _Typer(fn, cls, funcs, methods, {n: 0 for n in outer_names})
        if any(scope == s or scope.startswith(s + ".") for s in off_path):
            continue
        findings.extend(_check_function(sf, fn, typer, parents))
    return findings


def _static(e: ast.AST) -> bool:
    """Shape metadata of a tensor (no readback)."""
    if isinstance(e, ast.Attribute):
        return e.attr in _STATIC_ATTRS or _static(e.value)
    if isinstance(e, ast.Subscript):
        return _static(e.value)
    if isinstance(e, ast.Call):
        f = e.func
        if isinstance(f, ast.Name) and f.id == "len":
            return True
        return isinstance(f, ast.Attribute) and f.attr in _STATIC_METHODS
    return False


def _touches_packed(e: ast.AST) -> bool:
    return not _static(e) and any(
        isinstance(sub, ast.Attribute) and sub.attr == "problem" for sub in ast.walk(e)
    )


def _check_dispatch_file(sf: SourceFile) -> list[Finding]:
    findings: list[Finding] = []
    parents = build_parents(sf.tree)
    for fn in ast.walk(sf.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        peel_lines = [
            node.lineno
            for node in ast.walk(fn)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "peel"
        ]
        if not peel_lines:
            continue
        first_dispatch = min(peel_lines)
        scope = scope_of(fn, parents)
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call) and node.lineno < first_dispatch):
                continue
            name = call_name(node)
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS:
                target, what = f.value, f".{f.attr}()"
            elif (name in _NP_READBACKS or name in _COERCIONS) and node.args:
                target, what = node.args[0], f"{name}()"
            else:
                continue
            if _touches_packed(target):
                findings.append(
                    Finding(
                        rule=RULE,
                        path=sf.rel,
                        line=node.lineno,
                        scope=scope,
                        message=(
                            f"{what} reads a packed tensor back to the host before "
                            "dispatch (blocks the dispatch path on a device sync)"
                        ),
                        snippet=sf.line_text(node.lineno),
                    )
                )
    return findings


def check(ctx: AnalysisContext) -> list[Finding]:
    findings: list[Finding] = []
    for rel in ctx.config.trace_files:
        sf = ctx.get(rel)
        if sf is None:
            continue
        off_path = {
            key.split("::", 1)[1]
            for key in ctx.config.off_path_scopes
            if key.split("::", 1)[0] == rel
        }
        findings.extend(_check_hot_file(sf, off_path))
    for rel in ctx.config.dispatch_files:
        sf = ctx.get(rel)
        if sf is not None:
            findings.extend(_check_dispatch_file(sf))
    return findings
