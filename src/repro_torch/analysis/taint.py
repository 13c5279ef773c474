"""Capture-region discovery and device-value taint propagation (RPT1xx
engine).

A *capture region* is code whose tensor operations are recorded, not run
eagerly, so that a Python decision on a tensor's value or a copy to the
host breaks the capture (a graph break under ``torch.compile``, an error
or a value frozen into a CUDA graph):

* a def decorated with ``torch.compile`` or ``torch.jit.script``
  (directly, called with options, or through ``functools.partial``);
* a function or lambda passed to ``torch.compile``,
  ``torch.cuda.make_graphed_callables``, ``torch.jit.script`` or
  ``torch.jit.trace``;
* the body of ``with torch.cuda.graph(...)``.

Inside a function region the parameters are *tainted*, except ``self``,
``cls`` and parameters annotated with a Python scalar type (``int``,
``float``, ``bool``, ``str``, ``complex``): those are the counterpart of
JAX's static arguments.  Inside a graph block the enclosing function's
parameters (with the same exceptions) and the result of every ``torch.*``
call are tainted.  Taint flows through assignments and arbitrary calls,
and is killed by what is fixed while capturing — ``.shape``/``.ndim``/
``.dtype``/``.device``/``.is_cuda``, ``.size()``/``.dim()``/``.numel()``,
``len()``, ``isinstance()``, and ``is``/``is not`` comparisons (the
``x is None`` default-argument idiom is capture-safe).

The analysis is intraprocedural on purpose, as the JAX package's is: a
helper *called from* a region is not analyzed as captured (its
configuration parameters are legitimately branched on), so precision
beats recall.  The port's clean test keeps the false-positive rate at
zero.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Set, Tuple, Union

from repro_torch.analysis.core import ModuleContext

FunctionNode = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]

# capture entry point -> positional indices whose argument is captured
CAPTURE_WRAPPERS: Dict[str, Tuple[int, ...]] = {
    "torch.compile": (0,),
    "torch.cuda.make_graphed_callables": (0,),
    "torch.jit.script": (0,),
    "torch.jit.trace": (0,),
}

# decorators that make a def a capture region
CAPTURE_DECORATORS = ("torch.compile", "torch.jit.script")

GRAPH_CONTEXT = "torch.cuda.graph"

# attribute reads that are fixed while capturing (never carry taint)
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda"}

# methods whose result is fixed while capturing (``x.size(0)``)
STATIC_METHODS = {"size", "dim", "numel"}

# calls whose result is fixed while capturing
STATIC_CALLS = {"len", "isinstance", "type", "hasattr", "callable", "id"}

# Python casts that copy a device value to the host
HOST_CASTS = {"float", "int", "bool", "complex"}

# methods that wait for the device and copy to the host
HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}

# calls that wait for the device whatever their arguments
HOST_SYNC_CALLS = {"torch.cuda.synchronize"}

# parameter annotations that mark a Python scalar (not a tensor)
SCALAR_TYPES = {"int", "float", "bool", "str", "complex"}


@dataclasses.dataclass
class Region:
    """One capture region: its node (a def or lambda, or the ``with`` of a
    graph block), why it is captured, the names tainted on entry, and
    whether it is a CUDA-graph block (where every sync counts)."""

    node: ast.AST
    reason: str                  # e.g. "@torch.compile" or "torch.cuda.graph"
    seeds: Set[str]
    graph: bool = False


def _device_params(fn: Optional[FunctionNode]) -> Set[str]:
    """The parameters of ``fn`` that may hold tensors: all but ``self``,
    ``cls`` and those annotated with a Python scalar type."""
    if fn is None:
        return set()
    a = fn.args
    params = a.posonlyargs + a.args + a.kwonlyargs
    params += [p for p in (a.vararg, a.kwarg) if p is not None]
    out = set()
    for p in params:
        ann = p.annotation
        if p.arg in ("self", "cls") or (isinstance(ann, ast.Name)
                                         and ann.id in SCALAR_TYPES):
            continue
        out.add(p.arg)
    return out


def _local_def(ctx: ModuleContext, name: str) -> Optional[ast.FunctionDef]:
    for node in ctx.nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == name:
            return node
    return None


def _decorator_regions(ctx: ModuleContext) -> Iterable[Region]:
    for node in ctx.nodes:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for dec in node.decorator_list:
            # @torch.compile
            if ctx.resolves_to(dec, CAPTURE_DECORATORS):
                yield Region(node, f"@{ctx.resolve(dec)}",
                             _device_params(node))
            elif isinstance(dec, ast.Call):
                # @functools.partial(torch.compile, mode=...)
                if ctx.resolves_to(dec.func, ("functools.partial",)) \
                        and dec.args \
                        and ctx.resolves_to(dec.args[0], CAPTURE_DECORATORS):
                    yield Region(node,
                                 f"@partial({ctx.resolve(dec.args[0])})",
                                 _device_params(node))
                # @torch.compile(mode=...)
                elif ctx.resolves_to(dec.func, CAPTURE_DECORATORS):
                    yield Region(node, f"@{ctx.resolve(dec.func)}(...)",
                                 _device_params(node))


def _wrapper_call_regions(ctx: ModuleContext) -> Iterable[Region]:
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        target = ctx.resolve(node.func)
        if target not in CAPTURE_WRAPPERS:
            continue
        for idx in CAPTURE_WRAPPERS[target]:
            if idx >= len(node.args):
                continue
            arg = node.args[idx]
            # make_graphed_callables also takes a tuple of callables
            for fn_node in (arg.elts if isinstance(arg, (ast.Tuple, ast.List))
                            else [arg]):
                if isinstance(fn_node, ast.Lambda):
                    yield Region(fn_node, f"{target} arg",
                                 _device_params(fn_node))
                elif isinstance(fn_node, ast.Name):
                    fn = _local_def(ctx, fn_node.id)
                    if fn is not None:
                        yield Region(fn, f"{target} arg",
                                     _device_params(fn))


def _graph_regions(ctx: ModuleContext) -> Iterable[Region]:
    for node in ctx.nodes:
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        if any(isinstance(item.context_expr, ast.Call)
               and ctx.resolves_to(item.context_expr.func, (GRAPH_CONTEXT,))
               for item in node.items):
            yield Region(node, GRAPH_CONTEXT,
                         _device_params(ctx.enclosing_function(node)),
                         graph=True)


def capture_regions(ctx: ModuleContext) -> List[Region]:
    """All capture regions of a module, deduplicated by node."""
    seen: Set[int] = set()
    out: List[Region] = []
    for reg in list(_decorator_regions(ctx)) \
            + list(_wrapper_call_regions(ctx)) + list(_graph_regions(ctx)):
        if id(reg.node) not in seen:
            seen.add(id(reg.node))
            out.append(reg)
    return out


class TaintEngine:
    """Forward taint propagation over one region's body.

    Two passes: the first only propagates (so loop-carried taint settles),
    the second reports.  Nested function/class definitions are separate
    scopes and are skipped (they become their own regions if captured).
    """

    def __init__(self, ctx: ModuleContext, region: Region):
        self.ctx = ctx
        self.region = region
        self.tainted: Set[str] = set(region.seeds)

    # -- expression taint ----------------------------------------------------
    def is_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS:
                return False
            return self.is_tainted(node.value)
        if isinstance(node, ast.Call):
            fname = self.ctx.resolve(node.func)
            if fname in STATIC_CALLS:
                return False
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in STATIC_METHODS:
                return False
            if self.region.graph and fname and fname.startswith("torch."):
                return True               # a device tensor made in the graph
            parts = [a for a in node.args if not isinstance(a, ast.Starred)]
            parts += [a.value for a in node.args if isinstance(a, ast.Starred)]
            parts += [kw.value for kw in node.keywords]
            if isinstance(node.func, ast.Attribute):
                parts.append(node.func.value)   # method call on tainted obj
            return any(self.is_tainted(p) for p in parts)
        if isinstance(node, ast.Compare):
            # `x is None` / `x is not y` test the Python object, fixed
            # while capturing
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            return any(self.is_tainted(c)
                       for c in [node.left] + list(node.comparators))
        if isinstance(node, (ast.Lambda, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            return False
        return any(self.is_tainted(c) for c in ast.iter_child_nodes(node)
                   if isinstance(c, ast.expr))

    # -- statement walk ------------------------------------------------------
    def _target_names(self, node: ast.AST) -> List[str]:
        out = []
        for n in ast.walk(node):
            if isinstance(n, ast.Name):
                out.append(n.id)
        return out

    def _propagate_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(stmt, ast.Assign):
            t = self.is_tainted(stmt.value)
            for target in stmt.targets:
                if t:
                    self.tainted.update(self._target_names(target))
                elif isinstance(target, ast.Name):
                    self.tainted.discard(target.id)
            return
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            if self.is_tainted(stmt.value):
                self.tainted.update(self._target_names(stmt.target))
            elif isinstance(stmt.target, ast.Name):
                self.tainted.discard(stmt.target.id)
            return
        if isinstance(stmt, ast.AugAssign):
            if self.is_tainted(stmt.value):
                self.tainted.update(self._target_names(stmt.target))
            return
        if isinstance(stmt, ast.For):
            if self.is_tainted(stmt.iter):
                self.tainted.update(self._target_names(stmt.target))
        # walrus targets anywhere in the statement's expressions
        for n in ast.walk(stmt):
            if isinstance(n, ast.NamedExpr) and self.is_tainted(n.value):
                self.tainted.update(self._target_names(n.target))
        for body in _sub_bodies(stmt):
            for s in body:
                self._propagate_stmt(s)

    def propagate(self, passes: int = 2) -> None:
        if isinstance(self.region.node, ast.Lambda):
            return                       # lambdas: expression only, no stmts
        for _ in range(passes):
            for stmt in self.region.node.body:
                self._propagate_stmt(stmt)


def _sub_bodies(stmt: ast.stmt) -> List[List[ast.stmt]]:
    out = []
    for attr in ("body", "orelse", "finalbody"):
        b = getattr(stmt, attr, None)
        if b and isinstance(b, list) \
                and all(isinstance(s, ast.stmt) for s in b):
            out.append(b)
    for h in getattr(stmt, "handlers", []) or []:
        out.append(h.body)
    return out


def region_statements(region: Region) -> Iterable[ast.stmt]:
    """Every statement in the region body, skipping nested defs/classes
    (they are separate scopes)."""
    if isinstance(region.node, ast.Lambda):
        return
    stack = list(region.node.body)
    while stack:
        stmt = stack.pop(0)
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield stmt
        for body in _sub_bodies(stmt):
            stack.extend(body)


def region_expressions(region: Region) -> Iterable[ast.expr]:
    """Every expression evaluated in the region body: the lambda body for
    lambda regions, each statement's own expressions otherwise."""
    if isinstance(region.node, ast.Lambda):
        yield region.node.body
        return
    for stmt in region_statements(region):
        yield from statement_expressions(stmt)


def statement_expressions(stmt: ast.stmt) -> Iterable[ast.expr]:
    """The statement's own expressions (not those of nested statements or
    nested function bodies)."""
    for field, value in ast.iter_fields(stmt):
        vals = value if isinstance(value, list) else [value]
        for v in vals:
            if isinstance(v, ast.expr):
                yield v
            elif isinstance(v, ast.withitem):
                yield v.context_expr


def walk_expr(e: ast.expr) -> Iterable[ast.expr]:
    """Walk an expression tree without descending into lambda bodies."""
    yield e
    if isinstance(e, ast.Lambda):
        return
    for c in ast.iter_child_nodes(e):
        if isinstance(c, ast.expr):
            yield from walk_expr(c)
        elif isinstance(c, (ast.comprehension,)):
            for sub in [c.iter, c.target] + list(c.ifs):
                yield from walk_expr(sub)
        elif isinstance(c, ast.keyword):
            yield from walk_expr(c.value)
