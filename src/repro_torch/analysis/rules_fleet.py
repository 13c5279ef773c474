"""RPR3xx — fleet/artifact atomic-write discipline.

The fleet protocol (``repro_torch.fleet.manifest``) survives worker crashes
because every published artifact is either O_EXCL-linked (claims) or
``os.replace``-d into place (shards, manifests, bench artifacts).  A
plain ``open(path, 'w')`` anywhere on those paths reintroduces the
torn-file window the protocol exists to close.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from repro_torch.analysis.core import Finding, ModuleContext, rule

_WRITE_MODES = ("w", "w+", "wt", "w+t", "wb", "w+b")

TEMPFILE_MAKERS = (
    "tempfile.mkstemp",
    "tempfile.NamedTemporaryFile",
    "tempfile.TemporaryFile",
)


def _scope_of(ctx: ModuleContext, node: ast.AST) -> ast.AST:
    return ctx.enclosing_function(node) or ctx.tree


def _scope_calls(ctx: ModuleContext, scope: ast.AST,
                 names: Iterable[str]) -> bool:
    """Does the scope (not counting nested defs when scope is the module)
    call any of ``names``?"""
    target = set(names)
    for n in ast.walk(scope):
        if isinstance(n, ast.Call) and ctx.resolve(n.func) in target:
            return True
    return False


def _open_write_mode(node: ast.Call) -> Optional[str]:
    """The literal write mode of an ``open``/``.open`` call, else None."""
    mode: Optional[ast.expr] = None
    if len(node.args) > 1:
        mode = node.args[1]
    else:
        for kw in node.keywords:
            if kw.arg == "mode":
                mode = kw.value
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str) \
            and mode.value in _WRITE_MODES:
        return mode.value
    return None


@rule("RPR301", "plain truncating write bypasses the atomic-publish helpers")
def raw_truncating_write(ctx: ModuleContext) -> Iterable[Finding]:
    """``open(path, 'w')`` / ``Path.write_text`` truncate in place: a
    reader (or a crash) mid-write sees an empty/torn file.  Publish
    through ``repro_torch.utils.atomicio`` instead.  A function that itself
    finishes with ``os.replace``/``os.link`` IS an atomic publisher — its
    internal tmp-file write is the implementation, not a violation."""
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        is_open = (ctx.resolve(node.func) in ("open", "io.open", "os.fdopen")
                   and _open_write_mode(node) is not None)
        is_write_text = (isinstance(node.func, ast.Attribute)
                         and node.func.attr in ("write_text", "write_bytes"))
        if not (is_open or is_write_text):
            continue
        scope = _scope_of(ctx, node)
        if _scope_calls(ctx, scope, ("os.replace", "os.rename", "os.link")):
            continue
        what = "open(..., 'w')" if is_open else f".{node.func.attr}(...)"
        out.append(ctx.finding(
            "RPR301", node,
            f"{what} truncates the target in place (torn file on crash, "
            "partial read for concurrent readers); publish via "
            "repro_torch.utils.atomicio.atomic_write_text/_json"))
    return out


@rule("RPR302", "tempfile without dir= feeding an os.replace")
def cross_filesystem_replace(ctx: ModuleContext) -> Iterable[Finding]:
    """``tempfile.mkstemp()`` defaults to ``/tmp`` — usually a different
    filesystem from the artifact directory, where ``os.replace`` stops
    being atomic (EXDEV, or a copy+delete fallback).  Any tempfile that
    feeds a replace/rename must pin ``dir=`` next to the destination."""
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and ctx.resolve(node.func) in TEMPFILE_MAKERS):
            continue
        if any(kw.arg == "dir" for kw in node.keywords):
            continue
        scope = _scope_of(ctx, node)
        if _scope_calls(ctx, scope, ("os.replace", "os.rename")):
            out.append(ctx.finding(
                "RPR302", node,
                f"{ctx.resolve(node.func)}() without dir= defaults to "
                "/tmp, then the os.replace in this function crosses "
                "filesystems and loses atomicity; pass "
                "dir=os.path.dirname(dest) (or use "
                "repro_torch.utils.atomicio, which writes a sibling tmp)"))
    return out


_CLAIM_MARKERS = (".claim",)


def _mentions_claim(fn: ast.AST) -> bool:
    name = getattr(fn, "name", "")
    if "claim" in name.lower():
        return True
    for n in ast.walk(fn):
        if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                and any(m in n.value for m in _CLAIM_MARKERS):
            return True
    return False


def _has_excl_discipline(ctx: ModuleContext, fn: ast.AST) -> bool:
    for n in ast.walk(fn):
        if isinstance(n, ast.Call):
            name = ctx.resolve(n.func)
            if name == "os.link":
                return True
            if name in ("open", "io.open"):
                mode = None
                if len(n.args) > 1:
                    mode = n.args[1]
                else:
                    for kw in n.keywords:
                        if kw.arg == "mode":
                            mode = kw.value
                if isinstance(mode, ast.Constant) \
                        and isinstance(mode.value, str) \
                        and "x" in mode.value:
                    return True
        if isinstance(n, ast.Attribute) and n.attr == "O_EXCL":
            return True
    return False


@rule("RPR303", "claim-file creation without O_EXCL semantics")
def claim_without_excl(ctx: ModuleContext) -> Iterable[Finding]:
    """Claims are mutual-exclusion tokens: two workers racing a plain
    ``open(claim_path, 'w')`` both think they won.  Creation must be
    atomic-exclusive — ``os.link`` of a prewritten tmp, ``os.open`` with
    ``O_CREAT|O_EXCL``, or open mode ``'x'``."""
    out: List[Finding] = []
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not _mentions_claim(fn):
            continue
        creates = [n for n in ast.walk(fn)
                   if isinstance(n, ast.Call)
                   and ctx.resolve(n.func) in ("open", "io.open")
                   and _open_write_mode(n) is not None]
        if creates and not _has_excl_discipline(ctx, fn):
            out.append(ctx.finding(
                "RPR303", creates[0],
                f"`{getattr(fn, 'name', '?')}` creates a claim file with a "
                "plain truncating open: two racing workers both succeed. "
                "Use os.link of a tmp file, os.open(..., "
                "O_CREAT|O_EXCL) or open(mode='x')"))
    return out
