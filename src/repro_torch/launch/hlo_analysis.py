"""Cost analysis of a step: loop-aware HLO text parsing, and the port's
own counter of a PyTorch callable (the JAX package's
``repro.launch.hlo_analysis``).

**HLO text** (:func:`parse_computations`, :func:`analyze_text`,
:func:`top_collectives`; a copy of the reference's parser, stdlib only,
the same results on the same text: it reads HLO that XLA dumped, since
the port itself produces none).  ``compiled.cost_analysis()`` counts
while-loop bodies ONCE, ignoring trip count; this parser builds the
computation call graph, reads each while op's ``backend_config
known_trip_count``, and multiplies every computation's costs by its
execution count.  Per computation it tallies:
  * dot FLOPs: 2 · |result| · K (K = product of lhs contracting dims);
  * convolution FLOPs: 2 · |result| · (Cin/g) · prod(kernel spatial dims);
  * collective bytes: result bytes of all-gather / all-reduce /
    reduce-scatter / all-to-all / collective-permute;
  * HBM write bytes: result bytes of every materializing op (fusions are
    post-optimization, so op results ≈ buffers that actually hit memory).

**A torch callable** (:class:`CostCounter`, :func:`count_costs`,
:func:`top_ops`): a ``TorchDispatchMode`` that sees every ATen operation
of a call (autograd's backward included), on ``meta`` stand-ins or on a
device.  It tallies
  * FLOPs of the same two op classes as ``_dot_flops``/``_conv_flops``:
    the matrix products and convolutions (and attention) that
    ``torch.utils.flop_counter`` has formulas for, 2 · M · N · K each;
  * write bytes: every op's fresh outputs and the arguments it writes in
    place (eager PyTorch materialises each op's result: nothing is
    fused, so this is more than XLA's estimate of the same step);
  * collective bytes: the outputs of ``c10d`` collectives (0 with no
    process group);
  * live bytes: each fresh output's storage, from its creation to its
    release, and their peak over the call (the tensors that exist before
    the call, its arguments, are not counted).
Elementwise FLOPs are ignored (they are bandwidth-, not compute-bound).
"""

from __future__ import annotations

import collections
import dataclasses
import re
import weakref
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1, "s32": 4, "u32": 4,
    "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
    "token": 0, "opaque": 0,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_NO_TRAFFIC = {"get-tuple-element", "tuple", "parameter", "constant",
               "bitcast", "after-all", "partition-id", "replica-id", "iota"}

_RE_SHAPE = re.compile(r"([a-z0-9]+)\[([\d,]*)\]")
_RE_DEF = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(.*)$")
_RE_COMP = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*->.*\{")
_RE_TRIP = re.compile(r'known_trip_count[":{ ]+n["\s:]+\"?(\d+)')
_RE_CALL_SINGLE = re.compile(
    r"(?:calls|body|condition|to_apply|true_computation|false_computation)"
    r"=%?([\w.\-]+)")
_RE_CALL_LIST = re.compile(r"(?:branch_computations|called_computations)"
                           r"=\{([^}]*)\}")


def _shape_list(text: str) -> List[Tuple[str, List[int]]]:
    out = []
    for dt, dims in _RE_SHAPE.findall(text):
        if dt in _DTYPE_BYTES:
            out.append((dt, [int(d) for d in dims.split(",")] if dims else []))
    return out


def _nbytes(shapes) -> int:
    total = 0
    for dt, dims in shapes:
        n = 1
        for d in dims:
            n *= d
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclasses.dataclass
class OpInfo:
    name: str
    opcode: str
    result: List[Tuple[str, List[int]]]
    line: str


@dataclasses.dataclass
class CompCost:
    flops: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in _COLLECTIVES})
    write_bytes: float = 0.0
    calls: List[Tuple[str, float]] = dataclasses.field(default_factory=list)
    # (callee, multiplier): while bodies get trip count, others 1


def _opcode_of(rest: str) -> Optional[str]:
    """Extract the opcode: first identifier after the result shape."""
    # strip result shape(s): '(a, b)' tuple or single 'bf16[...]...'
    m = re.match(r"\(([^)]*)\)\s+([a-z][\w\-]*)\(", rest)
    if m:
        return m.group(2)
    m = re.match(r"[a-z0-9]+\[[\d,]*\]\S*\s+([a-z][\w\-]*)\(", rest)
    if m:
        return m.group(1)
    return None


def _dot_flops(line: str, result, symbols) -> float:
    # operand names: first parenthesized group after opcode
    m = re.search(r"\bdot\(([^)]*)\)", line)
    if not m:
        return 0.0
    operand_names = re.findall(r"%([\w.\-]+)", m.group(1))
    cdims = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", line)
    if not operand_names or cdims is None:
        return 0.0
    lhs = symbols.get(operand_names[0])
    if lhs is None or not lhs:
        return 0.0
    lhs_shape = lhs[0][1]
    k = 1
    for d in (cdims.group(1).split(",") if cdims.group(1) else []):
        di = int(d)
        if di < len(lhs_shape):
            k *= lhs_shape[di]
    n_out = 1
    for dt, dims in result:
        for d in dims:
            n_out *= d
        break
    return 2.0 * n_out * k


def _conv_flops(line: str, result, symbols) -> float:
    m = re.search(r"\bconvolution\(([^)]*)\)", line)
    if not m:
        return 0.0
    names = re.findall(r"%([\w.\-]+)", m.group(1))
    if len(names) < 2:
        return 0.0
    rhs = symbols.get(names[1])
    if not rhs:
        return 0.0
    kshape = rhs[0][1]
    n_out = 1
    for dt, dims in result:
        for d in dims:
            n_out *= d
        break
    # kernel: product of all dims except output-feature dim ~ Cin/g * spatial
    if kshape:
        k = 1
        for d in kshape:
            k *= d
        k //= max(result[0][1][1] if len(result[0][1]) > 1 else 1, 1)
        # crude: divide by output channels (dim 1 in NCHW) — good enough for
        # the CNN graphs; LLM dryruns contain no convolutions
        return 2.0 * n_out * max(k, 1)
    return 0.0


def parse_computations(text: str) -> Dict[str, CompCost]:
    comps: Dict[str, CompCost] = {}
    entry: Optional[str] = None
    cur: Optional[str] = None
    symbols: Dict[str, list] = {}
    for line in text.splitlines():
        if not line.strip():
            continue
        if not line.startswith(" "):           # computation header or junk
            m = _RE_COMP.match(line.strip())
            if m and "{" in line:
                cur = m.group(1)
                comps[cur] = CompCost()
                symbols = {}
                if line.strip().startswith("ENTRY"):
                    entry = cur
            continue
        if cur is None:
            continue
        if line.strip() == "}":
            cur = None
            continue
        m = _RE_DEF.match(line)
        if not m:
            continue
        name, rest = m.groups()
        result = _shape_list(rest.split(" ", 1)[0] if rest.startswith(("(", "f", "b", "s", "u", "p", "c", "t", "o"))
                             else rest)
        # more robust: take shapes before the opcode call paren
        head = rest.split("(")[0]
        result = _shape_list(head) or _shape_list(rest[:80])
        symbols[name] = result
        opcode = _opcode_of(rest) or ""
        cc = comps[cur]

        def _operand_bytes(idx: int) -> int:
            m2 = re.search(r"\b" + re.escape(opcode) + r"\(([^)]*)\)", line)
            if not m2:
                return 0
            names = re.findall(r"%([\w.\-]+)", m2.group(1))
            if idx >= len(names):
                return 0
            return _nbytes(symbols.get(names[idx]) or [])

        if opcode == "dot":
            cc.flops += _dot_flops(line, result, symbols)
            cc.write_bytes += (_nbytes(result) + _operand_bytes(0)
                               + _operand_bytes(1))
        elif opcode == "convolution":
            cc.flops += _conv_flops(line, result, symbols)
            cc.write_bytes += (_nbytes(result) + _operand_bytes(0)
                               + _operand_bytes(1))
        elif opcode in _COLLECTIVES:
            b = _nbytes(result)
            cc.coll_bytes += b
            cc.coll_by_kind[opcode] += b
            cc.write_bytes += 2 * b
        elif opcode in ("dynamic-slice", "gather", "slice", "scatter",
                        "concatenate"):
            cc.write_bytes += _nbytes(result)
        elif opcode == "dynamic-update-slice":
            cc.write_bytes += _operand_bytes(1) or _nbytes(result)
        elif opcode == "reduce":
            cc.write_bytes += _operand_bytes(0) + _nbytes(result)
        elif opcode == "copy":
            cc.write_bytes += 2 * _nbytes(result)
        # everything elementwise is assumed fused into neighbors on TPU
        # call edges
        callees = _RE_CALL_SINGLE.findall(rest)
        for grp in _RE_CALL_LIST.findall(rest):
            callees.extend(re.findall(r"%?([\w.\-]+)", grp))
        if callees:
            mult = 1.0
            if opcode == "while":
                t = _RE_TRIP.search(rest)
                mult = float(t.group(1)) if t else 1.0
            for callee in callees:
                # while body gets trip count; condition ~trip (close enough)
                comps[cur].calls.append((callee, mult))
    comps["__entry__"] = comps.get(entry, CompCost()) if entry else CompCost()
    comps["__entry_name__"] = entry  # type: ignore
    return comps


@dataclasses.dataclass
class HloCosts:
    flops: float
    coll_bytes: float
    coll_by_kind: Dict[str, float]
    write_bytes: float


def _multipliers(comps: Dict[str, CompCost], entry: Optional[str]
                 ) -> Dict[str, float]:
    """Each computation's execution count: a topological propagation over
    the call DAG from the entry (callers before callees; edge weights
    summed over call sites)."""
    edges: Dict[str, Dict[str, float]] = collections.defaultdict(dict)
    indeg: Dict[str, int] = {c: 0 for c in comps}
    for c, cc in comps.items():
        w: Dict[str, float] = collections.defaultdict(float)
        for callee, m in cc.calls:
            if callee in comps:
                w[callee] += m
        for callee, m in w.items():
            edges[c][callee] = m
            indeg[callee] += 1
    mult: Dict[str, float] = {c: 0.0 for c in comps}
    if entry:
        mult[entry] = 1.0
    order = collections.deque([c for c in comps if indeg[c] == 0])
    while order:
        c = order.popleft()
        for callee, m in edges[c].items():
            mult[callee] += mult[c] * m
            indeg[callee] -= 1
            if indeg[callee] == 0:
                order.append(callee)
    return mult


def analyze_text(text: str) -> HloCosts:
    comps = parse_computations(text)
    entry = comps.pop("__entry_name__", None)  # type: ignore
    comps.pop("__entry__", None)
    if entry is None:
        return HloCosts(0, 0, {k: 0 for k in _COLLECTIVES}, 0)
    mult = _multipliers(comps, entry)
    tot = HloCosts(0.0, 0.0, {k: 0.0 for k in _COLLECTIVES}, 0.0)
    for name, cc in comps.items():
        f = mult.get(name, 0.0)
        if f <= 0:
            continue
        tot.flops += f * cc.flops
        tot.coll_bytes += f * cc.coll_bytes
        tot.write_bytes += f * cc.write_bytes
        for k, v in cc.coll_by_kind.items():
            tot.coll_by_kind[k] += f * v
    return tot


def top_collectives(text: str, k: int = 15):
    """The k largest collectives of dumped HLO text (bytes × execution
    count) with the JAX op they came from (metadata ``op_name``), as
    ``(bytes, opcode, op_name, computation)`` tuples, largest first."""
    comps = parse_computations(text)
    entry = comps.pop("__entry_name__", None)  # type: ignore
    comps.pop("__entry__", None)
    mult = _multipliers(comps, entry)
    # a second pass over the text attributes each collective line
    out = []
    cur = None
    for line in text.splitlines():
        if not line.startswith(" "):
            m = _RE_COMP.match(line.strip())
            if m and "{" in line:
                cur = m.group(1)
            continue
        if cur is None or not any(c in line for c in _COLLECTIVES):
            continue
        mdef = _RE_DEF.match(line)
        if not mdef:
            continue
        rest = mdef.group(2)
        opcode = _opcode_of(rest)
        if opcode not in _COLLECTIVES:
            continue
        head = rest.split("(")[0]
        shapes = _shape_list(head) or _shape_list(rest[:100])
        nbytes = _nbytes(shapes) * max(mult.get(cur, 0.0), 0.0)
        mname = re.search(r'op_name="([^"]*)"', line)
        out.append((nbytes, opcode, mname.group(1) if mname else "?", cur))
    out.sort(reverse=True)
    return out[:k]


# -- the port's producer: a dispatch-mode counter of a torch callable ---------

_TORCH_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d")


def _tensors(tree) -> list:
    """The tensors of a nested list / tuple / dict (or a tensor)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return []


def _nbytes_of(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class OpTally:
    """One ATen operation's totals over a call."""
    calls: int = 0
    flops: float = 0.0
    write_bytes: float = 0.0


@dataclasses.dataclass(frozen=True)
class _OpInfo:
    """What the counter reads of an operation's schema, once per op."""
    name: str
    n_rets: int
    fresh: Tuple[int, ...]          # returns that alias no input
    written: Tuple[Tuple[int, str], ...]   # (position, name) written in place
    formula: object
    collective: bool

    @staticmethod
    def of(func) -> "_OpInfo":
        schema = func._schema
        rets = schema.returns
        written = tuple((i, a.name) for i, a in enumerate(schema.arguments)
                        if a.alias_info is not None and a.alias_info.is_write)
        return _OpInfo(str(func._overloadpacket), len(rets),
                       tuple(i for i, r in enumerate(rets)
                             if r.alias_info is None),
                       written, flop_registry.get(func._overloadpacket),
                       func.namespace in _TORCH_COLLECTIVE_NAMESPACES)


class CostCounter(TorchDispatchMode):
    """Counts FLOPs, write bytes, collective bytes and live bytes of every
    ATen operation run under it (``with CostCounter() as c: ...``); the
    module's docstring says what each counts.  ``ops`` holds each
    operation's totals (:func:`top_ops`), ``peak_bytes`` the most bytes
    the call held at once of those it allocated."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.write_bytes = 0.0
        self.coll_bytes = 0.0
        self.coll_by_kind: Dict[str, float] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.ops: Dict[str, OpTally] = {}
        self._tracked = WeakIdKeyDictionary()
        self._info: Dict[object, _OpInfo] = {}

    def _release(self, nbytes: int):
        self.live_bytes -= nbytes

    def _allocate(self, storage) -> None:
        if storage in self._tracked:
            return
        nbytes = storage.nbytes()
        self._tracked[storage] = nbytes
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(storage, self._release, nbytes)

    def costs(self) -> HloCosts:
        """The totals as :class:`HloCosts` (collectives by op name)."""
        return HloCosts(self.flops, self.coll_bytes,
                        dict(self.coll_by_kind), self.write_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        info = self._info.get(func)
        if info is None:
            info = self._info[func] = _OpInfo.of(func)
        written = 0
        if info.fresh:
            elems = (out,) if info.n_rets == 1 else out
            inputs = None
            for i in info.fresh:
                for t in _tensors(elems[i]):
                    st = t.untyped_storage()
                    if inputs is None:
                        inputs = {id(a.untyped_storage())
                                  for a in _tensors((args, kwargs))}
                    if id(st) in inputs:
                        continue                 # aliases an input
                    self._allocate(st)
                    written += _nbytes_of(t)
        for pos, name in info.written:
            arg = args[pos] if pos < len(args) else kwargs.get(name)
            written += sum(_nbytes_of(t) for t in _tensors(arg))
        flops = (float(info.formula(*args, **kwargs, out_val=out))
                 if info.formula is not None else 0.0)
        if info.collective:
            nb = float(sum(_nbytes_of(t) for t in _tensors(out)))
            self.coll_bytes += nb
            self.coll_by_kind[info.name] = (self.coll_by_kind.get(info.name,
                                                                  0.0) + nb)
        tally = self.ops.get(info.name)
        if tally is None:
            tally = self.ops[info.name] = OpTally()
        tally.calls += 1
        tally.flops += flops
        tally.write_bytes += written
        self.flops += flops
        self.write_bytes += written
        return out


def count_costs(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under a :class:`CostCounter`: ``(output,
    counter)``."""
    with CostCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter


def top_ops(counter: CostCounter, k: int = 15, by: str = "flops"):
    """The ``k`` operations of a counted call with the most ``by``
    (``"flops"`` or ``"write_bytes"``): ``(value, op, calls)``, largest
    first (the port's counterpart of the reference's ``top_collectives``)."""
    rows = [(getattr(t, by), name, t.calls)
            for name, t in counter.ops.items() if getattr(t, by)]
    rows.sort(reverse=True)
    return rows[:k]
