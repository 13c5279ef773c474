"""RPT1xx — capture-safety rules.

These guard the port's captured regions: ``torch.compile``d functions,
``torch.jit`` scripts and traces, and CUDA-graph captures of the decode,
train and search steps.  One Python branch on a device value or one host
sync inside such a region silently splits it (a graph break that runs the
rest eagerly), freezes a value into a CUDA graph, or raises only on the
card at capture time.  The port has no capture region yet; these rules
guard the work that adds them.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Set

from repro_torch.analysis.core import Finding, ModuleContext, rule
from repro_torch.analysis.taint import (HOST_CASTS, HOST_SYNC_CALLS,
                                        HOST_SYNC_METHODS, TaintEngine,
                                        capture_regions, region_expressions,
                                        region_statements, walk_expr)

# calls that build a capture object (each call compiles or records anew)
CAPTURE_BUILDERS = ("torch.compile", "torch.cuda.CUDAGraph",
                    "torch.cuda.make_graphed_callables")


@rule("RPT101", "Python control flow on a device value inside a capture "
                "region")
def python_branch_on_tensor(ctx: ModuleContext) -> Iterable[Finding]:
    out: List[Finding] = []
    seen: Set[int] = set()

    def report(node: ast.AST, message: str) -> None:
        if id(node) not in seen:
            seen.add(id(node))
            out.append(ctx.finding("RPT101", node, message))

    for region in capture_regions(ctx):
        eng = TaintEngine(ctx, region)
        eng.propagate()
        where = f"inside a capture region ({region.reason})"
        for stmt in region_statements(region):
            if isinstance(stmt, ast.If) and eng.is_tainted(stmt.test):
                report(stmt, f"Python `if` on a device value {where}; use "
                             "torch.where, or decide before the region")
            elif isinstance(stmt, ast.While) and eng.is_tainted(stmt.test):
                report(stmt, f"Python `while` on a device value {where}; "
                             "fix the trip count on the host")
            elif isinstance(stmt, ast.For) and eng.is_tainted(stmt.iter):
                report(stmt, f"Python `for` over a device value {where}; "
                             "iterate over a range of a fixed size")
            elif isinstance(stmt, ast.Assert) and eng.is_tainted(stmt.test):
                report(stmt, f"`assert` on a device value {where}; use "
                             "torch._assert_async or check outside the "
                             "region")
        for e in region_expressions(region):
            for sub in walk_expr(e):
                if isinstance(sub, ast.IfExp) and eng.is_tainted(sub.test):
                    report(sub, "conditional expression on a device value "
                                f"{where}; use torch.where")
    return out


@rule("RPT102", "host sync inside a capture region")
def host_sync_in_capture(ctx: ModuleContext) -> Iterable[Finding]:
    out: List[Finding] = []
    seen: Set[int] = set()

    def report(node: ast.AST, message: str) -> None:
        if id(node) not in seen:
            seen.add(id(node))
            out.append(ctx.finding("RPT102", node, message))

    for region in capture_regions(ctx):
        eng = TaintEngine(ctx, region)
        eng.propagate()
        where = f"inside a capture region ({region.reason})"
        for e in region_expressions(region):
            for sub in walk_expr(e):
                if not isinstance(sub, ast.Call):
                    continue
                fname = ctx.resolve(sub.func)
                args_tainted = any(eng.is_tainted(a) for a in sub.args)
                if fname in HOST_SYNC_CALLS:
                    report(sub, f"`{fname}()` {where} waits for the device "
                                "and breaks the capture")
                elif fname in HOST_CASTS and args_tainted:
                    report(sub, f"`{fname}()` on a device value {where} "
                                "copies it to the host and breaks the "
                                "capture; keep it a tensor")
                elif fname and fname.startswith("numpy.") \
                        and args_tainted:
                    report(sub, f"`{fname}` on a device value {where} "
                                "pulls the buffer to the host; use the "
                                "torch operation")
                elif isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr in HOST_SYNC_METHODS \
                        and (region.graph
                             or eng.is_tainted(sub.func.value)):
                    report(sub, f"`.{sub.func.attr}()` {where} waits for "
                                "the device and copies to the host")
    return out


@rule("RPT103", "capture object built inside a loop (compiled or recorded "
                "every iteration)")
def capture_in_loop(ctx: ModuleContext) -> Iterable[Finding]:
    out: List[Finding] = []
    for node in ctx.nodes:
        if not (isinstance(node, ast.Call)
                and ctx.resolves_to(node.func, CAPTURE_BUILDERS)):
            continue
        for anc in ctx.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                break               # loops outside the def don't re-run it
            if isinstance(anc, (ast.For, ast.While)):
                out.append(ctx.finding(
                    "RPT103", node,
                    f"{ctx.resolve(node.func)}(...) inside a loop compiles "
                    "or records anew every iteration; build it once "
                    "outside the loop (or cache it by shape)"))
                break
    return out
