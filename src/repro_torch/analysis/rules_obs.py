"""RPR4xx — monotonic-clock discipline for timing code.

The serve runtime, the fleet protocol and the observability layer all
measure durations (stage occupancy, TTFT, lease heartbeats, span walls).
``time.time()`` and wall-clock ``datetime`` are the wrong instruments for
that: NTP slew, DST shifts and manual clock changes make their differences
jump backwards or by hours, which silently corrupts latency percentiles,
health EWMAs and trace spans.  Inside ``repro_torch/serve/``,
``repro_torch/fleet/`` and ``repro_torch/obs/`` every elapsed-time
measurement must use ``time.perf_counter()`` (or ``time.monotonic()``).

Comparing against an *epoch-stamped external fact* (e.g. a file mtime in
``Manifest.reclaim_stale``) genuinely needs ``time.time()`` — such sites
are acknowledged in the analysis baseline, not rewritten.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.core import Finding, ModuleContext, rule

# directories under the monotonic-clock contract
_SCOPED_DIRS = ("repro_torch/serve/", "repro_torch/fleet/",
                "repro_torch/obs/")

_TIME_CLOCKS = ("time.time",)
_DATETIME_CLOCKS = (
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
    "datetime.datetime.today",
    "datetime.date.today",
)


def _in_scope(ctx: ModuleContext) -> bool:
    return any(ctx.in_package_dir(d) for d in _SCOPED_DIRS)


def _scope_id(ctx: ModuleContext, node: ast.AST) -> int:
    return id(ctx.enclosing_function(node) or ctx.tree)


def _tainted_names(ctx: ModuleContext, clocks: Sequence[str]
                   ) -> Dict[Tuple[int, str], str]:
    """Names assigned straight from a wall-clock call, keyed by their
    enclosing scope — ``t0 = time.time()`` taints ``t0`` for later
    subtraction checks within the same function (or module body)."""
    clock_set = set(clocks)
    out: Dict[Tuple[int, str], str] = {}
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)):
            continue
        resolved = ctx.resolve(node.value.func)
        if resolved not in clock_set:
            continue
        scope = _scope_id(ctx, node)
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                out[(scope, tgt.id)] = resolved
    return out


def _duration_findings(ctx: ModuleContext, rule_id: str,
                       clocks: Sequence[str], advice: str
                       ) -> Iterable[Finding]:
    """Flag subtractions where an operand is a wall-clock read — directly
    (``time.time() - t0``) or through a name assigned from one."""
    if not _in_scope(ctx):
        return []
    clock_set = set(clocks)
    tainted = _tainted_names(ctx, clocks)
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.BinOp)
                and isinstance(node.op, ast.Sub)):
            continue
        culprit: Optional[str] = None
        for operand in (node.left, node.right):
            if isinstance(operand, ast.Call):
                resolved = ctx.resolve(operand.func)
                if resolved in clock_set:
                    culprit = f"{resolved}()"
                    break
            elif isinstance(operand, ast.Name):
                key = (_scope_id(ctx, node), operand.id)
                if key in tainted:
                    culprit = f"{operand.id} (assigned from {tainted[key]}())"
                    break
        if culprit is not None:
            out.append(ctx.finding(
                rule_id, node,
                f"duration measured by subtracting {culprit}: wall clocks "
                f"jump under NTP slew/DST and corrupt the elapsed value; "
                f"{advice}"))
    return out


@rule("RPR401", "time.time() subtraction measures a duration on a wall clock")
def walltime_duration(ctx: ModuleContext) -> Iterable[Finding]:
    """``time.time() - t0`` (or a name assigned from ``time.time()`` used
    in a subtraction) inside ``repro_torch/serve``, ``repro_torch/fleet``
    or ``repro_torch/obs`` — elapsed time there must come from
    ``time.perf_counter()`` / ``time.monotonic()``.  A subtraction against
    an epoch-stamped external fact (file mtime, message timestamp) is the
    one legitimate use; acknowledge it in the analysis baseline."""
    return _duration_findings(
        ctx, "RPR401", _TIME_CLOCKS,
        "use time.perf_counter() (or time.monotonic()) for both endpoints")


@rule("RPR402", "datetime arithmetic measures a duration on a wall clock")
def datetime_duration(ctx: ModuleContext) -> Iterable[Finding]:
    """``datetime.now() - started`` style arithmetic in the scoped runtime
    dirs: same wall-clock hazard as RPR401 with extra timezone/DST failure
    modes.  Durations come from ``time.perf_counter()``; ``datetime`` is
    for formatting moments, not measuring intervals."""
    return _duration_findings(
        ctx, "RPR402", _DATETIME_CLOCKS,
        "take time.perf_counter() at both endpoints and subtract those")
