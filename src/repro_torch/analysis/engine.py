"""Lint engine: file loading, rule driving, fingerprints, baselines.

The counterpart of ``repro.analysis.engine``, pointed at the port.  It is
deliberately pure-stdlib (``ast`` + ``hashlib``): the analysis runs in a
bare container in well under a second, without importing torch or the
package under analysis.

Fingerprints are content-addressed, not line-addressed: a finding hashes
``rule | path | scope | normalized-snippet | occurrence-index``.  Adding
a docstring above a bad call moves its line but not its fingerprint, so
the baseline (``src/repro_torch/analysis/baseline.json``) does not churn
on unrelated edits.  The occurrence index disambiguates textually
identical findings within one scope (ordered by line).
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import re
from pathlib import Path
from typing import Iterable

__all__ = [
    "AnalysisConfig",
    "AnalysisContext",
    "Finding",
    "SourceFile",
    "apply_baseline",
    "load_baseline",
    "render_text",
    "report_dict",
    "run",
    "write_baseline",
]

# A suppression may share a comment with prose ("# isolation downward;
# trusslint: disable=R5"), so only anchor on the marker itself.
_SUPPRESS_RE = re.compile(r"trusslint:\s*disable=([A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)")

RULE_IDS = ("R1", "R2", "R3", "R4", "R5", "R6")


# ---------------------------------------------------------------------- #
# Findings
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one site."""

    rule: str
    path: str  # repo-relative, posix separators
    line: int
    scope: str  # dotted enclosing scope, e.g. "Planner.execute"
    message: str
    snippet: str  # normalized source line (whitespace-collapsed)
    occurrence: int = 0

    @property
    def fingerprint(self) -> str:
        basis = "|".join(
            (self.rule, self.path, self.scope, self.snippet, str(self.occurrence))
        )
        return hashlib.sha256(basis.encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint
        return d


# ---------------------------------------------------------------------- #
# Source files
# ---------------------------------------------------------------------- #
class SourceFile:
    """A parsed source file plus its suppression comments."""

    def __init__(self, path: Path, rel: str):
        self.path = path
        self.rel = rel
        self.source = path.read_text()
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=str(path))
        self.suppressed: dict[int, set[str]] = {}
        for i, text in enumerate(self.lines, 1):
            m = _SUPPRESS_RE.search(text)
            if m:
                self.suppressed[i] = {
                    r.strip() for r in m.group(1).split(",") if r.strip()
                }

    def line_text(self, lineno: int) -> str:
        if 0 < lineno <= len(self.lines):
            return " ".join(self.lines[lineno - 1].split())
        return ""

    def is_suppressed(self, rule: str, lineno: int) -> bool:
        return rule in self.suppressed.get(lineno, ())


# ---------------------------------------------------------------------- #
# Configuration
# ---------------------------------------------------------------------- #
def _iter_py(root: Path, subdir: str) -> list[Path]:
    base = root / subdir
    if not base.is_dir():
        return []
    return sorted(p for p in base.rglob("*.py") if "__pycache__" not in p.parts)


@dataclasses.dataclass
class AnalysisConfig:
    """Which files each rule looks at.

    Everything is expressed as repo-relative paths so the tests can
    re-point individual rules at fixture files without touching the
    engine.
    """

    root: Path
    files: list[Path]
    # R1: the hot-path files whose functions must not read the device back
    # (``trace_files``), and files whose pre-``.peel`` dispatch path must
    # not read packed tensors back.
    trace_files: list[str]
    dispatch_files: list[str]
    # R2: files holding builder/variant-key pairs.
    recompile_files: list[str]
    # R3: files with guarded-by annotated classes.
    lock_files: list[str]
    # R4: the fault-site declaration and the tests that must cover it.
    faults_file: str
    test_files: list[str]
    # R5: the name registry and every file whose metric calls it governs.
    names_file: str
    metric_ref_files: list[str]
    # R6: the wire codec and the error taxonomy.
    wire_file: str
    errors_file: str
    # R1: scopes of ``trace_files`` that never run on the card's peel,
    # ``"path::Scope"`` -> why (the kernels' plain versions, diagnostics).
    off_path_scopes: dict[str, str] = dataclasses.field(default_factory=dict)

    @classmethod
    def default(cls, root: Path | str = ".") -> "AnalysisConfig":
        """The port: ``src/repro_torch``, its tests and ``chip_smoke.py``."""
        root = Path(root).resolve()
        files = _iter_py(root, "src/repro_torch")
        files += sorted((root / "tests").glob("test_torch_*.py"))
        if (root / "chip_smoke.py").is_file():
            files.append(root / "chip_smoke.py")

        def rel(p: Path) -> str:
            return p.relative_to(root).as_posix()

        rels = [rel(p) for p in files]
        tests = [r for r in rels if r.startswith("tests/")]
        pkg = "src/repro_torch/"
        return cls(
            root=root,
            files=files,
            trace_files=[
                pkg + "exec/peel.py",
                pkg + "kernels/support_fine.py",
                pkg + "kernels/peel_fused.py",
                pkg + "core/eager_fine.py",
                pkg + "distributed/ktruss.py",
                pkg + "graphs/pack.py",  # validate_fused_tiling: every fused dispatch
            ],
            dispatch_files=[pkg + "api/planner.py", pkg + "exec/peel.py"],
            recompile_files=[pkg + "api/cache.py", pkg + "api/planner.py"],
            lock_files=[
                pkg + "api/session.py",
                pkg + "api/planner.py",
                pkg + "serve/router.py",
                pkg + "serve/replica.py",
            ],
            faults_file=pkg + "resilience/faults.py",
            test_files=tests,
            names_file=pkg + "obs/names.py",
            metric_ref_files=rels,
            wire_file=pkg + "serve/wire.py",
            errors_file=pkg + "errors.py",
            off_path_scopes={
                pkg + "kernels/support_fine.py::_lower_bound": (
                    "the plain twin's binary search, one readback a step (CPU only)"
                ),
                pkg + "kernels/peel_fused.py::fused_level_torch": (
                    "the fused kernel's plain version (CPU only)"
                ),
                pkg + "kernels/peel_fused.py::split_items": (
                    "diagnostics: the kernel's work-item counts, for tests and chip_smoke.py"
                ),
                pkg + "exec/peel.py::_EagerTrips": (
                    "the unfused trip loop off CUDA, its condition read on the host each "
                    "trip (free on the CPU); on the card the loop is a graph replay"
                ),
            },
        )


class AnalysisContext:
    """Loaded sources shared by every rule."""

    def __init__(self, config: AnalysisConfig):
        self.config = config
        self.files: dict[str, SourceFile] = {}
        self.errors: list[Finding] = []
        for path in config.files:
            rel = path.relative_to(config.root).as_posix()
            try:
                self.files[rel] = SourceFile(path, rel)
            except (SyntaxError, UnicodeDecodeError, OSError) as e:
                self.errors.append(
                    Finding(
                        rule="E0",
                        path=rel,
                        line=getattr(e, "lineno", 0) or 0,
                        scope="<module>",
                        message=f"file could not be parsed: {e}",
                        snippet="",
                    )
                )

    def get(self, rel: str) -> SourceFile | None:
        return self.files.get(rel)

    def test_sources(self) -> Iterable[SourceFile]:
        for rel in self.config.test_files:
            sf = self.get(rel)
            if sf is not None:
                yield sf


# ---------------------------------------------------------------------- #
# AST helpers shared by rules
# ---------------------------------------------------------------------- #
def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> str | None:
    return dotted_name(call.func)


def build_parents(tree: ast.AST) -> dict[ast.AST, ast.AST]:
    parents: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def scope_of(node: ast.AST, parents: dict[ast.AST, ast.AST]) -> str:
    names: list[str] = []
    cur: ast.AST | None = node
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.append(cur.name)
        cur = parents.get(cur)
    return ".".join(reversed(names)) or "<module>"


def const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


# ---------------------------------------------------------------------- #
# Running
# ---------------------------------------------------------------------- #
def _assign_occurrences(findings: list[Finding]) -> list[Finding]:
    groups: dict[tuple, list[Finding]] = {}
    for f in findings:
        groups.setdefault((f.rule, f.path, f.scope, f.snippet), []).append(f)
    out: list[Finding] = []
    for members in groups.values():
        members.sort(key=lambda f: f.line)
        for i, f in enumerate(members):
            out.append(dataclasses.replace(f, occurrence=i))
    out.sort(key=lambda f: (f.path, f.line, f.rule, f.occurrence))
    return out


def run(config: AnalysisConfig, rules: list | None = None) -> list[Finding]:
    """Run the rule set and return suppression-filtered findings."""
    from . import (
        rules_faults,
        rules_locks,
        rules_metrics,
        rules_recompile,
        rules_trace,
        rules_wire,
    )

    ctx = AnalysisContext(config)
    modules = rules if rules is not None else [
        rules_trace,
        rules_recompile,
        rules_locks,
        rules_faults,
        rules_metrics,
        rules_wire,
    ]
    findings: list[Finding] = list(ctx.errors)
    for mod in modules:
        findings.extend(mod.check(ctx))

    kept = []
    seen: set[tuple] = set()
    for f in findings:
        sf = ctx.files.get(f.path)
        if sf is not None and sf.is_suppressed(f.rule, f.line):
            continue
        key = (f.rule, f.path, f.line, f.message)
        if key in seen:  # overlapping traced scopes can double-visit
            continue
        seen.add(key)
        kept.append(f)
    return _assign_occurrences(kept)


# ---------------------------------------------------------------------- #
# Baseline
# ---------------------------------------------------------------------- #
def load_baseline(path: Path | str) -> set[str]:
    path = Path(path)
    if not path.exists():
        return set()
    data = json.loads(path.read_text())
    return {entry["fingerprint"] for entry in data.get("findings", [])}


def write_baseline(path: Path | str, findings: list[Finding]) -> None:
    data = {
        "version": 1,
        "findings": [
            {
                "fingerprint": f.fingerprint,
                "rule": f.rule,
                "path": f.path,
                "scope": f.scope,
                "message": f.message,
            }
            for f in findings
        ],
    }
    Path(path).write_text(json.dumps(data, indent=2, sort_keys=True) + "\n")


def apply_baseline(
    findings: list[Finding], baseline: set[str]
) -> tuple[list[Finding], list[Finding], set[str]]:
    """Split findings into (new, baselined) and report stale entries."""
    new: list[Finding] = []
    old: list[Finding] = []
    live = {f.fingerprint for f in findings}
    for f in findings:
        (old if f.fingerprint in baseline else new).append(f)
    stale = baseline - live
    return new, old, stale


# ---------------------------------------------------------------------- #
# Reports
# ---------------------------------------------------------------------- #
def report_dict(
    new: list[Finding],
    baselined: list[Finding],
    stale: set[str],
    config: AnalysisConfig,
) -> dict:
    return {
        "version": 1,
        "tool": "repro_torch.analysis",
        "files_scanned": len(config.files),
        "counts": {
            "new": len(new),
            "baselined": len(baselined),
            "stale_baseline": len(stale),
        },
        "findings": [dict(f.to_dict(), baselined=False) for f in new]
        + [dict(f.to_dict(), baselined=True) for f in baselined],
        "stale_baseline": sorted(stale),
    }


def render_text(new: list[Finding], baselined: list[Finding], stale: set[str]) -> str:
    out: list[str] = []
    for f in new:
        out.append(
            f"{f.path}:{f.line}: {f.rule} [{f.scope}] {f.message} [{f.fingerprint}]"
        )
    if baselined:
        out.append(f"({len(baselined)} baselined finding(s) suppressed)")
    for fp in sorted(stale):
        out.append(f"stale baseline entry {fp}: finding no longer present")
    if not new and not stale:
        out.append("repro_torch.analysis: clean")
    return "\n".join(out)
