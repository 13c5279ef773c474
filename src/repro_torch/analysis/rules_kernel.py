"""RPT2xx — CUDA launch contracts of ``repro_torch/kernels/``.

The port's kernels are CUDA sources built by ``nvcc`` into libraries with
a plain C interface and called through ``ctypes``, one Python wrapper a
kernel.  ctypes checks nothing the C side relies on: it passes a surplus
argument silently, an error code nobody reads leaves the output tensor
full of garbage, and a wrapper that counts its launches anywhere but
where it launches makes the smoke run's proof that the main path went
through the kernels wrong.  These rules check the parts of the contract
that are statically visible, in the files under ``repro_torch/`` (a root
script such as ``chip_variants.py``, which loads its own peak probes, is
outside them):

* kernels are loaded (``_build.load``) and launched (``lib.*_launch``)
  in ``repro_torch/kernels/`` only, and built at first use, never while a
  module is imported;
* a launch passes exactly the arguments its ``argtypes`` declares, and
  its result is compared and raised on;
* the wrapper raises its own ``launches`` by one after a successful
  launch, and nothing else raises a counter;
* callers outside ``kernels/`` thread ``impl`` into ``kernels.ops``; on a
  CUDA tensor a wrapper launches or raises: no handler falls back to the
  plain version and no device is chosen by ``torch.cuda.is_available()``.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.core import (Finding, ModuleContext,
                                       iter_python_files, rule)

PORT_DIR = "repro_torch/"
KERNELS_DIR = "repro_torch/kernels/"
OPS = "repro_torch.kernels.ops."
REF = "repro_torch.kernels.ref."

LOADERS = (
    "ctypes.CDLL",
    "ctypes.cdll.LoadLibrary",
    "torch.utils.cpp_extension.load",
    "torch.utils.cpp_extension.load_inline",
    "triton.jit",
)

FunctionNode = (ast.FunctionDef, ast.AsyncFunctionDef)


def _in_port(ctx: ModuleContext) -> bool:
    return ctx.in_package_dir(PORT_DIR)


def _in_kernels(ctx: ModuleContext) -> bool:
    return ctx.in_package_dir(KERNELS_DIR)


def _launch_name(node: ast.AST) -> Optional[str]:
    """``name_launch`` of a ``lib.name_launch(...)`` call, else None."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr.endswith("_launch"):
        return node.func.attr
    return None


def _launches(node: ast.AST) -> List[ast.Call]:
    return [n for n in ast.walk(node) if _launch_name(n)]


def _module_launches(ctx: ModuleContext) -> List[ast.Call]:
    return [n for n in ctx.nodes if _launch_name(n)]


def _is_build_load(name: Optional[str]) -> bool:
    return bool(name) and (name == "_build.load"
                           or name.endswith("._build.load"))


def _loader(ctx: ModuleContext, node: ast.AST) -> Optional[str]:
    """What a kernel-loading call or decorator loads with, else None."""
    target = node.func if isinstance(node, ast.Call) else node
    name = ctx.resolve(target)
    if name in LOADERS or _is_build_load(name):
        return name
    return None


def _kernel_wrappers(ctx: ModuleContext) -> Dict[str, ast.AST]:
    """The module-level functions of a ``kernels/`` module that launch a
    kernel, by name."""
    if not _in_kernels(ctx):
        return {}
    return {fn.name: fn for fn in ctx.tree.body
            if isinstance(fn, FunctionNode) and _launches(fn)}


def kernel_wrappers(kernels_dir: str) -> List[str]:
    """Dotted names (``repro_torch.kernels.<module>.<function>``) of the
    wrappers that launch a kernel in the ``*.py`` files of
    ``kernels_dir``, the directory of the package ``repro_torch.kernels``;
    sorted."""
    out: List[str] = []
    for path in iter_python_files([kernels_dir]):
        rel = os.path.relpath(path, kernels_dir).replace(os.sep, "/")
        with open(path) as f:
            ctx = ModuleContext(path, f.read(), KERNELS_DIR + rel)
        module = "repro_torch.kernels." + rel[:-3].replace("/", ".")
        out += [f"{module}.{name}" for name in _kernel_wrappers(ctx)]
    return sorted(out)


# -- RPT201: loads and launches outside kernels/ -----------------------------
@rule("RPT201", "kernel loaded or launched outside repro_torch/kernels/")
def launch_outside_kernels(ctx: ModuleContext) -> Iterable[Finding]:
    """Every kernel is built, loaded and launched behind
    ``repro_torch.kernels`` so that validation, the launch check and the
    launch count happen exactly once."""
    if not _in_port(ctx) or _in_kernels(ctx):
        return []
    out: List[Finding] = []
    for node in ctx.nodes:
        what = None
        if isinstance(node, ast.Call):
            what = _loader(ctx, node) or _launch_name(node)
        elif isinstance(node, FunctionNode):
            for dec in node.decorator_list:
                what = what or _loader(ctx, dec)
        if what:
            out.append(ctx.finding(
                "RPT201", node,
                f"`{what}` outside repro_torch/kernels/; build and launch "
                "the kernel in a wrapper there and call it through "
                "repro_torch.kernels.ops"))
    return out


# -- RPT202: launch arity against argtypes -----------------------------------
def _list_length(node: ast.AST) -> Optional[int]:
    """Length of a literal list expression: ``[a, b]``, ``[a] * k`` and
    ``+`` of those; None when it is dynamic."""
    if isinstance(node, (ast.List, ast.Tuple)):
        if any(isinstance(e, ast.Starred) for e in node.elts):
            return None
        return len(node.elts)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = _list_length(node.left), _list_length(node.right)
        return None if a is None or b is None else a + b
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for seq, k in ((node.left, node.right), (node.right, node.left)):
            if isinstance(k, ast.Constant) and type(k.value) is int:
                n = _list_length(seq)
                return None if n is None else n * k.value
    return None


def _argtypes(ctx: ModuleContext) -> Dict[str, Optional[int]]:
    """``*_launch`` name -> argument count its ``argtypes`` declares in
    this module (None when dynamic or declared twice differently)."""
    out: Dict[str, Optional[int]] = {}
    for node in ctx.nodes:
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Attribute) and t.attr == "argtypes" \
                    and isinstance(t.value, ast.Attribute) \
                    and t.value.attr.endswith("_launch"):
                n = _list_length(node.value)
                name = t.value.attr
                out[name] = n if out.get(name, n) == n else None
    return out


@rule("RPT202", "kernel launch argument count differs from its argtypes")
def launch_arity(ctx: ModuleContext) -> Iterable[Finding]:
    """ctypes passes surplus arguments on silently (a missing one
    raises): every ``lib.x_launch(...)`` passes exactly the arguments
    ``lib.x_launch.argtypes`` declares in the same module."""
    if not _in_port(ctx):
        return []
    declared = _argtypes(ctx)
    out: List[Finding] = []
    for call in _module_launches(ctx):
        want = declared.get(_launch_name(call))
        if want is None or call.keywords \
                or any(isinstance(a, ast.Starred) for a in call.args):
            continue
        if len(call.args) != want:
            out.append(ctx.finding(
                "RPT202", call,
                f"`{_launch_name(call)}` called with {len(call.args)} "
                f"arguments but its argtypes declares {want}; ctypes "
                "does not check the count — pass exactly the C "
                "signature's arguments"))
    return out


# -- RPT203: unchecked launch results ----------------------------------------
def _raises(stmts: List[ast.stmt]) -> bool:
    return any(isinstance(n, ast.Raise) for s in stmts for n in ast.walk(s))


def _tests_name(test: ast.expr, name: str) -> bool:
    """``if code:`` or a comparison with ``code`` as an operand."""
    if isinstance(test, ast.Name):
        return test.id == name
    return any(isinstance(n, ast.Compare)
               and any(isinstance(o, ast.Name) and o.id == name
                       for o in [n.left] + list(n.comparators))
               for n in ast.walk(test))


def _raising_helpers(ctx: ModuleContext) -> Dict[str, Tuple[List[str],
                                                             Set[str]]]:
    """Module-level functions that raise on one of their parameters:
    name -> (positional parameter names, the parameters raised on)."""
    out = {}
    for fn in ctx.tree.body:
        if not isinstance(fn, FunctionNode):
            continue
        params = [p.arg for p in fn.args.posonlyargs + fn.args.args]
        raising = [n.test for n in ast.walk(fn)
                   if isinstance(n, ast.If) and _raises(n.body)]
        checked = {p for p in params + [p.arg for p in fn.args.kwonlyargs]
                   if any(_tests_name(t, p) for t in raising)}
        if checked:
            out[fn.name] = (params, checked)
    return out


def _check_site(ctx: ModuleContext, call: ast.Call,
                helpers: Dict[str, Tuple[List[str], Set[str]]]
                ) -> Optional[ast.AST]:
    """The statement or call that compares a launch's result and raises on
    it — ``if code != 0: raise``, a module-local helper that does, or the
    launch itself inside such a test — else None."""
    parent = ctx.parents.get(id(call))
    if isinstance(parent, ast.Compare):
        stmt = ctx.parents.get(id(parent))
        if isinstance(stmt, ast.If) and _raises(stmt.body):
            return stmt
        return None
    if not (isinstance(parent, ast.Assign) and len(parent.targets) == 1
            and isinstance(parent.targets[0], ast.Name)):
        return None
    name = parent.targets[0].id
    after = getattr(parent, "end_lineno", parent.lineno)
    scope = ctx.enclosing_function(call) or ctx.tree
    for n in ast.walk(scope):
        if getattr(n, "lineno", 0) <= after:
            continue
        if isinstance(n, ast.If) and _tests_name(n.test, name) \
                and _raises(n.body):
            return n
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                and n.func.id in helpers:
            params, checked = helpers[n.func.id]
            passed = {params[i] for i, a in enumerate(n.args)
                      if i < len(params) and isinstance(a, ast.Name)
                      and a.id == name}
            passed |= {kw.arg for kw in n.keywords
                       if isinstance(kw.value, ast.Name)
                       and kw.value.id == name}
            if passed & checked:
                return n
    return None


@rule("RPT203", "kernel launch result not compared and raised on")
def unchecked_launch(ctx: ModuleContext) -> Iterable[Finding]:
    """A launch that fails (bad configuration, too much shared memory, no
    kernel image for the card) returns an error code and leaves the
    output as it was allocated: unread, it is silent garbage.  The result
    must reach ``if code != 0: raise ...``, directly or through a
    module-local helper that raises."""
    if not _in_port(ctx):
        return []
    helpers = _raising_helpers(ctx)
    return [ctx.finding(
        "RPT203", call,
        f"the result of `{_launch_name(call)}` is never compared and raised "
        "on; a failed launch leaves the output uninitialised — `if code "
        "!= 0: raise RuntimeError(...)`")
        for call in _module_launches(ctx)
        if _check_site(ctx, call, helpers) is None]


# -- RPT204: literal impl="ref" into kernels.ops -----------------------------
@rule("RPT204", "literal impl=\"ref\" passed to repro_torch.kernels.ops")
def hardcoded_ref_impl(ctx: ModuleContext) -> Iterable[Finding]:
    """Call sites thread ``impl`` from their caller (default ``"auto"``):
    a literal ``impl="ref"`` outside ``kernels/`` runs the plain version
    on a card and the kernel never launches."""
    if not _in_port(ctx) or _in_kernels(ctx):
        return []
    out: List[Finding] = []
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        name = ctx.resolve(node.func)
        if not (name and name.startswith(OPS)):
            continue
        for kw in node.keywords:
            if kw.arg == "impl" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value == "ref":
                out.append(ctx.finding(
                    "RPT204", kw.value,
                    f"impl=\"ref\" is hardcoded in the call of `{name}`; "
                    "thread the caller's impl so a CUDA tensor launches "
                    "the kernel"))
    return out


# -- RPT205: builds at import time -------------------------------------------
def _runs_at_import(ctx: ModuleContext, node: ast.AST) -> bool:
    """True unless ``node`` lies in the body of a def or lambda (a
    decorator or a default value runs when the module is imported)."""
    child = node
    for anc in ctx.ancestors(node):
        if isinstance(anc, FunctionNode) \
                and any(child is s for s in anc.body):
            return False
        if isinstance(anc, ast.Lambda) and child is anc.body:
            return False
        child = anc
    return True


@rule("RPT205", "kernel built or loaded while the module is imported")
def build_at_import(ctx: ModuleContext) -> Iterable[Finding]:
    """Kernels build at first use (``functools.lru_cache`` ``_lib()``):
    every module is imported by the CPU tests and by processes that never
    launch, where there is no ``nvcc`` and no card."""
    if not _in_port(ctx):
        return []
    out: List[Finding] = []
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        name = ctx.resolve(node.func) or ""
        last = name.rsplit(".", 1)[-1]
        if (_is_build_load(name) or last in ("build_all", "_lib")) \
                and _runs_at_import(ctx, node):
            out.append(ctx.finding(
                "RPT205", node,
                f"`{name}()` runs while the module is imported; build and "
                "load the kernel at first use, inside the wrapper "
                "(a functools.lru_cache `_lib()`)"))
    return out


# -- RPT206: launch counters -------------------------------------------------
def _is_counter_bump(node: ast.AST) -> bool:
    return isinstance(node, ast.AugAssign) \
        and isinstance(node.target, ast.Attribute) \
        and node.target.attr == "launches"


def _own_bump(node: ast.AugAssign, fn: ast.AST) -> bool:
    """``fn.launches += 1`` for the function ``fn`` itself."""
    return isinstance(node.target.value, ast.Name) \
        and node.target.value.id == fn.name \
        and isinstance(node.op, ast.Add) \
        and isinstance(node.value, ast.Constant) and node.value.value == 1


@rule("RPT206", "launch counter not raised once by its own wrapper after "
                "the launch")
def launch_counter(ctx: ModuleContext) -> Iterable[Finding]:
    """Each wrapper that launches raises its own ``<wrapper>.launches`` by
    one after a successful launch (after the launch's check), and no other
    code raises a ``.launches``: the counts prove which kernels a path
    ran."""
    if not _in_port(ctx):
        return []
    wrappers = _kernel_wrappers(ctx)
    helpers = _raising_helpers(ctx)
    out: List[Finding] = []
    own: Dict[str, List[ast.AugAssign]] = {name: [] for name in wrappers}
    for node in ctx.nodes:
        if not _is_counter_bump(node):
            continue
        fn = ctx.enclosing_function(node)
        if fn is not None and wrappers.get(getattr(fn, "name", "")) is fn \
                and _own_bump(node, fn):
            own[fn.name].append(node)
        else:
            out.append(ctx.finding(
                "RPT206", node,
                "`.launches` raised outside its own launching wrapper; "
                "only a kernel wrapper counts, `<wrapper>.launches += 1` "
                "after its launch"))
    for name, fn in wrappers.items():
        bumps = own[name]
        if len(bumps) != 1:
            out.append(ctx.finding(
                "RPT206", fn,
                f"`{name}` launches a kernel but raises `{name}.launches` "
                f"{len(bumps)} times; raise it once, after the launch's "
                "check"))
            continue
        sites = [_check_site(ctx, c, helpers) or c for c in _launches(fn)]
        last = max(getattr(s, "end_lineno", s.lineno) for s in sites)
        if bumps[0].lineno <= last:
            out.append(ctx.finding(
                "RPT206", bumps[0],
                f"`{name}.launches` is raised before the launch is checked; "
                "count only a successful launch"))
    return out


# -- RPT207: fallbacks to the plain version on a card ------------------------
def _reaches_kernel(ctx: ModuleContext, stmts: List[ast.stmt]) -> bool:
    for s in stmts:
        for n in ast.walk(s):
            if _launch_name(n):
                return True
            if isinstance(n, ast.Call):
                name = ctx.resolve(n.func) or ""
                if name.startswith("repro_torch.kernels.") \
                        and not name.startswith(REF):
                    return True
    return False


def _falls_back(ctx: ModuleContext, stmts: List[ast.stmt]) -> bool:
    for s in stmts:
        for n in ast.walk(s):
            if isinstance(n, ast.Call) \
                    and (ctx.resolve(n.func) or "").startswith(REF):
                return True
            if isinstance(n, ast.keyword) and n.arg == "impl" \
                    and isinstance(n.value, ast.Constant) \
                    and n.value.value == "ref":
                return True
    return False


def _asks_cuda(ctx: ModuleContext, test: ast.expr) -> bool:
    return any(isinstance(n, ast.Call)
               and ctx.resolves_to(n.func, ("torch.cuda.is_available",))
               for n in ast.walk(test))


def _chooses(stmts: List[ast.stmt]) -> bool:
    """The branch binds or returns something (not only raises)."""
    return any(isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign,
                              ast.Return))
               for s in stmts for n in ast.walk(s))


@rule("RPT207", "fallback to the plain version on a card")
def fallback_on_card(ctx: ModuleContext) -> Iterable[Finding]:
    """On a CUDA tensor a wrapper launches its kernel or raises.  An
    ``except`` around a launch (or a ``kernels`` call) that runs
    ``kernels.ref`` or passes ``impl="ref"`` hides a broken kernel behind
    the plain version; a device chosen by ``torch.cuda.is_available()``
    moves a run to the CPU where the caller asked for the card."""
    if not _in_port(ctx):
        return []
    out: List[Finding] = []
    for node in ctx.nodes:
        if isinstance(node, ast.Try) and _reaches_kernel(ctx, node.body):
            for h in node.handlers:
                if _falls_back(ctx, h.body):
                    out.append(ctx.finding(
                        "RPT207", h,
                        "the handler around a kernel falls back to the "
                        "plain version; on a CUDA tensor launch or raise"))
        elif isinstance(node, ast.IfExp) and _asks_cuda(ctx, node.test):
            out.append(ctx.finding(
                "RPT207", node,
                "device chosen by torch.cuda.is_available(); take the "
                "device from the caller (the entry points default to "
                "the card and raise without one)"))
        elif isinstance(node, ast.If) and _asks_cuda(ctx, node.test) \
                and (_chooses(node.body) or _chooses(node.orelse)):
            out.append(ctx.finding(
                "RPT207", node,
                "branch on torch.cuda.is_available() chooses what runs; "
                "take the device from the caller and raise without a "
                "card"))
    return out
