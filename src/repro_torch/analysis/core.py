"""Analyzer core: findings, module context, rule registry, driver.

The analyzer is a plain ``ast`` pass over the port's own source (stdlib
only: it imports neither torch nor jax, so it runs in any CI leg and on a
machine without either).  Rules are repo-specific: they encode the
contract surfaces whose breakage is silent or runtime-only — capture
safety of ``torch.compile``/CUDA-graph regions (RPT1xx), the CUDA launch
contracts of ``repro_torch/kernels/`` (RPT2xx), the fleet/artifact
atomic-write discipline (RPR3xx) and monotonic-clock timing discipline
(RPR4xx).  The last two families keep the JAX package's rule ids, so
findings compare rule by rule.  ``python -m repro_torch.analysis
--list-rules`` prints the catalog; a rule is a function registered with
:func:`rule`.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str          # e.g. "RPR101"
    message: str       # human-readable, names the fix
    file: str          # path relative to the analysis root (posix sep)
    line: int
    col: int
    context: str       # enclosing function qualname, or "<module>"

    def key(self) -> Tuple[str, str, str]:
        """Baseline-matching identity: stable across unrelated edits
        (no line numbers)."""
        return (self.rule, self.file, self.context)

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return (f"{self.file}:{self.line}:{self.col}: {self.rule} "
                f"[{self.context}] {self.message}")


class ModuleContext:
    """Parsed module plus the name-resolution helpers every rule needs."""

    def __init__(self, path: str, source: str, relpath: str):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.parents: Dict[int, ast.AST] = {}
        self._qualnames: Dict[int, str] = {}
        self.imports: Dict[str, str] = {}
        self.nodes: List[ast.AST] = []      # every node, walked once
        self._index()

    # -- construction --------------------------------------------------------
    def _index(self) -> None:
        for node in ast.walk(self.tree):
            self.nodes.append(node)
            for child in ast.iter_child_nodes(node):
                self.parents[id(child)] = node
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.imports[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.imports[a.asname or a.name] = (
                        f"{node.module}.{a.name}")

    # -- queries -------------------------------------------------------------
    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted name of an expression through the module's import aliases:
        ``pl.pallas_call`` -> ``jax.experimental.pallas.pallas_call``.
        None for anything that isn't a plain Name/Attribute chain."""
        if isinstance(node, ast.Name):
            return self.imports.get(node.id, node.id)
        if isinstance(node, ast.Attribute):
            base = self.resolve(node.value)
            return f"{base}.{node.attr}" if base else None
        return None

    def resolves_to(self, node: ast.AST, names: Sequence[str]) -> bool:
        return self.resolve(node) in set(names)

    def qualname(self, node: ast.AST) -> str:
        """Enclosing function qualname for a node ('<module>' at top level,
        'Outer.inner' for nested defs)."""
        if id(node) in self._qualnames:
            return self._qualnames[id(node)]
        parts: List[str] = []
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(cur.name)
            elif isinstance(cur, ast.Lambda):
                parts.append("<lambda>")
            cur = self.parents.get(id(cur))
        out = ".".join(reversed(parts)) or "<module>"
        self._qualnames[id(node)] = out
        return out

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self.parents.get(id(node))
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return cur
            cur = self.parents.get(id(cur))
        return None

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parents.get(id(node))
        while cur is not None:
            yield cur
            cur = self.parents.get(id(cur))

    def in_package_dir(self, fragment: str) -> bool:
        """True when the module path contains ``fragment`` (posix form,
        e.g. 'repro_torch/kernels/')."""
        return fragment in self.relpath

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return Finding(rule=rule, message=message, file=self.relpath,
                       line=getattr(node, "lineno", 0),
                       col=getattr(node, "col_offset", 0),
                       context=self.qualname(node))


RuleFn = Callable[[ModuleContext], Iterable[Finding]]


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    title: str
    fn: RuleFn


_RULES: Dict[str, Rule] = {}


def rule(rule_id: str, title: str) -> Callable[[RuleFn], RuleFn]:
    """Register a rule function: ``fn(ctx) -> iterable of Finding``."""
    def deco(fn: RuleFn) -> RuleFn:
        if rule_id in _RULES:
            raise ValueError(f"duplicate rule id {rule_id}")
        _RULES[rule_id] = Rule(rule_id, title, fn)
        return fn
    return deco


def all_rules() -> List[Rule]:
    _load_builtin_rules()
    return [_RULES[k] for k in sorted(_RULES)]


def _load_builtin_rules() -> None:
    # imported lazily so `import repro_torch.analysis.core` alone never cycles
    from repro_torch.analysis import rules_fleet  # noqa: F401
    from repro_torch.analysis import rules_kernel  # noqa: F401
    from repro_torch.analysis import rules_obs  # noqa: F401
    from repro_torch.analysis import rules_trace  # noqa: F401


def iter_python_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in sorted(dirnames)
                           if not d.startswith(".") and d != "__pycache__"]
            out.extend(os.path.join(dirpath, f) for f in sorted(filenames)
                       if f.endswith(".py"))
    return out


def analyze_file(path: str, root: Optional[str] = None,
                 rules: Optional[Sequence[Rule]] = None
                 ) -> List[Finding]:
    """Run (selected) rules over one file; syntax errors become a single
    RPR000 finding rather than an exception."""
    root = root or os.getcwd()
    rel = os.path.relpath(os.path.abspath(path), os.path.abspath(root))
    with open(path) as f:
        source = f.read()
    try:
        ctx = ModuleContext(path, source, rel)
    except SyntaxError as e:
        return [Finding("RPR000", f"syntax error: {e.msg}",
                        rel.replace(os.sep, "/"), e.lineno or 0,
                        e.offset or 0, "<module>")]
    findings: List[Finding] = []
    for r in (rules if rules is not None else all_rules()):
        findings.extend(r.fn(ctx))
    findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    return findings


def analyze_paths(paths: Sequence[str], root: Optional[str] = None,
                  select: Optional[Sequence[str]] = None
                  ) -> Tuple[List[Finding], int]:
    """Analyze every ``.py`` under ``paths``; returns (findings, n_files).

    ``select`` filters rules by id prefix (``["RPR3"]`` runs only the fleet
    family); unknown prefixes raise ValueError.
    """
    rules = all_rules()
    if select:
        known = {r.id for r in rules}
        for s in select:
            if not any(k.startswith(s) for k in known):
                raise ValueError(
                    f"--select {s!r} matches no rule; have "
                    f"{', '.join(sorted(known))}")
        rules = [r for r in rules if any(r.id.startswith(s) for s in select)]
    files = iter_python_files(paths)
    findings: List[Finding] = []
    for f in files:
        findings.extend(analyze_file(f, root=root, rules=rules))
    return findings, len(files)
