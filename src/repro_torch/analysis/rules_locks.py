"""R3 — lock-discipline.

Lock invariants are written down next to the data they protect, and this
rule makes the annotations load-bearing:

* ``self.X = ...  # guarded-by: _lock`` on an ``__init__`` assignment
  declares that every touch of ``self.X`` outside ``__init__`` must
  happen while ``self._lock`` is held.
* ``def _register(self, ...):  # requires-lock: _lock`` declares that a
  method runs with the lock already held — its body is checked as
  locked, and every same-class call site must hold the lock.
* ``self._lock = threading.Lock()  # trusslint: io-lock`` designates a
  lock whose held regions are *allowed* to block on IO (a per-connection
  send/recv lock), opting it out of the blocking-call check only.

With those inputs the rule tracks ``with self.<lock>:`` regions through
each method and flags (a) guarded attribute access outside the guarding
lock, (b) blocking calls — socket/RPC/dispatch/subprocess/sleep/device
synchronisation — while any non-io lock is held (lock-convoy on the routing/session path), and
(c) calls to ``requires-lock`` methods without the lock.

Scope limits, by design: only ``self.``-rooted locks and attributes are
tracked, and only within the class that declares them.  Cross-object
locking (``session._cv`` from a future) is the annotation owner's
responsibility.
"""

from __future__ import annotations

import ast
import re

from .engine import AnalysisContext, Finding, SourceFile, build_parents

RULE = "R3"

_GUARD_RE = re.compile(r"self\.(\w+)\s*(?::[^=]+)?=.*#.*guarded-by:\s*(\w+)")
_REQUIRES_RE = re.compile(r"#\s*requires-lock:\s*(\w+)")
_IO_LOCK_RE = re.compile(r"self\.(\w+)\s*(?::[^=]+)?=.*#\s*trusslint:\s*io-lock")

# Callee terminal names that block: wire IO, dispatch, subprocess, sleep,
# a device synchronisation.
_BLOCKING_CALLS = {
    "accept",
    "block_until_ready",
    "check_call",
    "check_output",
    "communicate",
    "connect",
    "create_connection",
    "dispatch",
    "execute",
    "health",
    "peel",
    "ping",
    "Popen",
    "recv",
    "recv_msg",
    "result",
    "rpc",
    "run_batch",
    "send_msg",
    "sendall",
    "shutdown_replica",
    "sleep",
    "solve",
    "submit",
    "synchronize",
}


def _class_span(cls: ast.ClassDef) -> tuple[int, int]:
    return cls.lineno, cls.end_lineno or cls.lineno


def _annotations(
    sf: SourceFile, cls: ast.ClassDef
) -> tuple[dict[str, str], set[str], dict[str, str]]:
    """(guarded attr -> lock, io locks, requires-lock method -> lock)."""
    lo, hi = _class_span(cls)
    guards: dict[str, str] = {}
    io_locks: set[str] = set()
    for lineno in range(lo, min(hi, len(sf.lines)) + 1):
        text = sf.lines[lineno - 1]
        m = _GUARD_RE.search(text)
        if m:
            guards[m.group(1)] = m.group(2)
        m = _IO_LOCK_RE.search(text)
        if m:
            io_locks.add(m.group(1))
    requires: dict[str, str] = {}
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            m = _REQUIRES_RE.search(sf.lines[node.lineno - 1])
            if m:
                requires[node.name] = m.group(1)
    return guards, io_locks, requires


def _with_locks(node: ast.With, lock_names: set[str]) -> set[str]:
    """Locks acquired by ``with self.<lock>[, ...]:``."""
    acquired: set[str] = set()
    for item in node.items:
        expr = item.context_expr
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and expr.attr in lock_names
        ):
            acquired.add(expr.attr)
    return acquired


class _MethodChecker(ast.NodeVisitor):
    def __init__(
        self,
        sf: SourceFile,
        cls: ast.ClassDef,
        method: ast.AST,
        guards: dict[str, str],
        io_locks: set[str],
        requires: dict[str, str],
    ):
        self.sf = sf
        self.cls = cls
        self.method = method
        self.guards = guards
        self.io_locks = io_locks
        self.requires = requires
        self.lock_names = set(guards.values()) | io_locks | set(requires.values())
        self.held: set[str] = set()
        self.in_init = method.name == "__init__"
        self.findings: list[Finding] = []
        req = requires.get(method.name)
        if req:
            self.held.add(req)

    def _emit(self, node: ast.AST, message: str) -> None:
        self.findings.append(
            Finding(
                rule=RULE,
                path=self.sf.rel,
                line=node.lineno,
                scope=f"{self.cls.name}.{self.method.name}",
                message=message,
                snippet=self.sf.line_text(node.lineno),
            )
        )

    def visit_With(self, node: ast.With) -> None:
        acquired = _with_locks(node, self.lock_names) - self.held
        for item in node.items:
            self.visit(item.context_expr)
        self.held |= acquired
        for stmt in node.body:
            self.visit(stmt)
        self.held -= acquired

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # Nested defs (worker closures, futures) run on their own thread
        # or later in time; lock state does not flow into them.
        saved, self.held = self.held, set()
        self.generic_visit(node)
        self.held = saved

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (
            not self.in_init
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and node.attr in self.guards
            and self.guards[node.attr] not in self.held
        ):
            self._emit(
                node,
                f"self.{node.attr} is guarded-by {self.guards[node.attr]} "
                "but accessed without it",
            )
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        # requires-lock call sites (self.method(...))
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id == "self"
            and func.attr in self.requires
            and self.requires[func.attr] not in self.held
        ):
            self._emit(
                node,
                f"self.{func.attr}() requires-lock "
                f"{self.requires[func.attr]} but is called without it",
            )
        # blocking calls under a non-io lock
        hot = self.held - self.io_locks
        if hot:
            name = func.attr if isinstance(func, ast.Attribute) else (
                func.id if isinstance(func, ast.Name) else None
            )
            if name in _BLOCKING_CALLS:
                locks = ", ".join(sorted(hot))
                self._emit(
                    node,
                    f"blocking call {name}() while holding {locks} "
                    "(stalls every thread contending for the lock)",
                )
        self.generic_visit(node)


def _check_class(sf: SourceFile, cls: ast.ClassDef) -> list[Finding]:
    guards, io_locks, requires = _annotations(sf, cls)
    if not guards and not requires and not io_locks:
        return []
    findings: list[Finding] = []
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            checker = _MethodChecker(sf, cls, node, guards, io_locks, requires)
            for stmt in node.body:
                checker.visit(stmt)
            findings.extend(checker.findings)
    return findings


def check(ctx: AnalysisContext) -> list[Finding]:
    findings: list[Finding] = []
    for rel in ctx.config.lock_files:
        sf = ctx.get(rel)
        if sf is None:
            continue
        build_parents(sf.tree)
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(_check_class(sf, node))
    return findings
