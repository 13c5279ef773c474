"""Tensor fast-path of :meth:`PartitionEvaluator.evaluate_batch`.

The NumPy batch evaluator already reduces a candidate evaluation to gathers
over precomputed tables (per-arch latency/energy prefix sums, per-position
link element counts, the Def.-3 :class:`SegmentMemoryTable` and the proxy
accuracy weight prefix).  This module exports exactly those tables as
tensors on a device (:class:`EvalTables`, built by
:func:`build_eval_tables` / :meth:`PartitionEvaluator.torch_tables`) and a
pure function over them (:func:`make_batch_eval_fn`), so the NSGA-II
generation loop of ``repro_torch.core.nsga2_torch`` scores a whole
population on the device in one call.

The table *values* are an argument of the function built by
:func:`make_runtime_eval_fn`, so one evaluation function serves every
same-shape table set (degraded links, shrunk memory capacities, perturbed
cost tables); two tables are interchangeable iff their
:meth:`EvalTables.shape_signature` match.

Semantics mirror ``evaluate_batch`` metric for metric; arithmetic is
float32, so agreement is to float32 tolerance rather than bit-exact.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.partition import Constraints, PartitionEvaluator

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EvalTables:
    """Evaluator state as tensors (leading dims: P platforms, K links,
    L schedule positions)."""

    L: int                          # schedule length
    n_cuts: int                     # == K
    cost_prefix: Tensor             # (P, 2, L+1) latency/energy prefix sums
    cut_elems: Tensor               # (max(L-1, 1),) elements over each cut
    producer_bpe: Tensor            # (K,) bytes/element at the producer side
    link_rate: Tensor               # (K,) raw line rate, bit/s
    link_setup: Tensor              # (K,) per-transfer setup, s
    link_payload: Tensor            # (K,) MTU payload bytes
    link_header: Tensor             # (K,) per-packet header bytes
    link_power: Tensor              # (K,) p_tx + p_rx, W
    link_e_byte: Tensor             # (K,) transceiver J/byte
    mem_base_prefix: Tensor         # (L+1,) ungrouped-parameter prefix sum
    mem_groups: Tuple[Tuple[Tensor, Tensor], ...]  # per shared group:
    #                                 (sorted member positions, member params)
    act_sparse: Tensor              # (levels, L) range-max sparse table
    bytes_per_param: Tensor         # (P,)
    bytes_per_act: Tensor           # (P,)
    capacity: Tensor                # (P,)
    batch: int
    acc_weight_prefix: Optional[Tensor]  # (L+1,) or None (no proxy oracle)
    acc_noise: Optional[Tensor]          # (P,) quantization noise per platform
    acc_base: float
    acc_scale: float

    @property
    def supports_accuracy(self) -> bool:
        """Whether a proxy-accuracy oracle was exported."""
        return self.acc_weight_prefix is not None

    @property
    def device(self) -> torch.device:
        """The device the tables live on."""
        return self.cost_prefix.device

    def to(self, device) -> "EvalTables":
        """The same tables on ``device``."""
        def mv(a):
            return None if a is None else a.to(device)
        kw = {f: mv(getattr(self, f)) for f in TABLE_ARRAYS}
        kw["mem_groups"] = tuple((pos.to(device), par.to(device))
                                 for pos, par in self.mem_groups)
        return dataclasses.replace(self, **kw)

    def shape_signature(self) -> Tuple:
        """Hashable signature of everything the evaluation function's
        shapes depend on: statics, tensor shapes and dtypes.  Tables with
        equal signatures can be fed to the same function."""
        def sig(a):
            if a is None:
                return None
            return (tuple(a.shape), str(a.dtype))
        return (self.L, self.n_cuts, self.batch,
                self.acc_base, self.acc_scale,
                tuple((f, sig(getattr(self, f))) for f in TABLE_ARRAYS),
                tuple((sig(pos), sig(par)) for pos, par in self.mem_groups))


TABLE_ARRAYS = (
    "cost_prefix", "cut_elems", "producer_bpe", "link_rate", "link_setup",
    "link_payload", "link_header", "link_power", "link_e_byte",
    "mem_base_prefix", "act_sparse", "bytes_per_param", "bytes_per_act",
    "capacity", "acc_weight_prefix", "acc_noise")
TABLE_STATICS = ("L", "n_cuts", "batch", "acc_base", "acc_scale")


def _evaluator_arrays(evaluator: PartitionEvaluator) -> Tuple[Dict, Dict]:
    """The evaluator's tables as NumPy arrays plus the statics, in the
    layout :func:`tables_from_numpy` takes."""
    system = evaluator.system
    plats = system.platforms
    L = len(evaluator.schedule)
    elems = evaluator.cut_elements() if L > 1 else np.zeros(1, dtype=np.int64)
    if len(elems) == 0:
        elems = np.zeros(1, dtype=np.int64)
    links = system.links
    mt = evaluator._memtable
    acc = evaluator.accuracy_fn
    if hasattr(acc, "proxy_arrays"):
        wpre, noise, base, scale = acc.proxy_arrays()
    else:
        wpre = noise = None
        base, scale = 1.0, 0.0
    arrays = dict(
        cost_prefix=np.stack([evaluator._prefix[p.arch.name] for p in plats]),
        cut_elems=elems,
        producer_bpe=([p.quant.bits / 8.0 for p in plats[:-1]]
                      if len(plats) > 1 else [0.0]),
        link_rate=[l.rate_bps for l in links] or [1.0],
        link_setup=[l.t_setup_s for l in links] or [0.0],
        link_payload=[l.payload_bytes for l in links] or [1.0],
        link_header=[l.header_bytes for l in links] or [0.0],
        link_power=[l.p_tx_w + l.p_rx_w for l in links] or [0.0],
        link_e_byte=[l.e_per_byte_j for l in links] or [0.0],
        mem_base_prefix=mt.base_prefix,
        mem_groups=[(pos, gpar) for pos, gpar in mt.groups],
        act_sparse=mt.act_sparse if L else np.zeros((1, 1)),
        bytes_per_param=[p.memory_model.bytes_per_param for p in plats],
        bytes_per_act=[p.memory_model.act_bytes for p in plats],
        capacity=[p.capacity for p in plats],
        acc_weight_prefix=wpre, acc_noise=noise)
    statics = dict(L=L, n_cuts=system.n_cuts, batch=evaluator.batch,
                   acc_base=float(base), acc_scale=float(scale))
    return arrays, statics


def tables_from_numpy(arrays: Dict, statics: Dict, device) -> EvalTables:
    """Build :class:`EvalTables` on ``device`` from host arrays.

    ``arrays`` maps every name of :data:`TABLE_ARRAYS` (the optional
    accuracy ones may be None) and ``mem_groups`` — a sequence of
    (positions, params) pairs — to array-likes; ``statics`` maps the names
    of :data:`TABLE_STATICS`.  This is how tables exported elsewhere (e.g.
    the fields of the JAX package's ``EvalTables``, given as NumPy arrays)
    are carried across: floats become float32, positions int32.
    """
    def f32(a):
        return (None if a is None
                else torch.as_tensor(np.asarray(a, dtype=np.float64),
                                     dtype=torch.float32).to(device))
    kw = {f: f32(arrays[f]) for f in TABLE_ARRAYS}
    kw["mem_groups"] = tuple(
        (torch.as_tensor(np.asarray(pos, dtype=np.int64),
                         dtype=torch.int32).to(device), f32(gpar))
        for pos, gpar in arrays["mem_groups"])
    kw.update({k: statics[k] for k in TABLE_STATICS})
    kw["acc_base"] = float(kw["acc_base"])
    kw["acc_scale"] = float(kw["acc_scale"])
    return EvalTables(**kw)


def build_eval_tables(evaluator: PartitionEvaluator, device) -> EvalTables:
    """Export an evaluator's precomputed tables as tensors on ``device``.

    Accuracy tables are present only when the evaluator's oracle exposes the
    :meth:`~repro_torch.core.accuracy.ProxyAccuracy.proxy_arrays` protocol
    (measured oracles are host-side by nature).
    """
    arrays, statics = _evaluator_arrays(evaluator)
    return tables_from_numpy(arrays, statics, device)


def _segment_memory(t: EvalTables, aa: Tensor, bb: Tensor,
                    valid: Tensor) -> Tensor:
    """Def.-3 memory of schedule[aa..bb] per (row, platform), elementwise
    version of :meth:`SegmentMemoryTable.batched` (0 where invalid)."""
    par = t.mem_base_prefix[bb + 1] - t.mem_base_prefix[aa]
    for pos, gpar in t.mem_groups:
        idx = torch.clamp(torch.searchsorted(pos, aa.to(pos.dtype)),
                          max=len(pos) - 1)
        hit = (pos[idx] >= aa) & (pos[idx] <= bb)
        par = par + torch.where(hit, gpar[idx], 0.0)
    length = (bb - aa + 1).to(torch.float32)
    k = torch.frexp(length).exponent.to(torch.int64) - 1   # floor(log2(len))
    w = torch.ones_like(k) << k
    peak = torch.maximum(t.act_sparse[k, aa],
                         t.act_sparse[k, bb - w + 1]) * t.batch
    mem = (par * t.bytes_per_param[None, :]
           + peak * t.bytes_per_act[None, :])
    return torch.where(valid, torch.floor(mem), 0.0)


def make_runtime_eval_fn(template: EvalTables, objectives: Sequence[str],
                         constraints: Optional[Constraints] = None,
                         ) -> Callable[[Tensor, EvalTables],
                                       Tuple[Tensor, Tensor]]:
    """Build ``eval(C, tables) -> (F, CV)`` with the tables as an argument.

    ``objectives``/``constraints`` and the shape statics of ``template``
    are fixed; the table *values* are read from the ``tables`` argument at
    call time, so one function serves every :class:`EvalTables` whose
    :meth:`~EvalTables.shape_signature` equals the template's.  Raises if
    accuracy is needed (objective or ``min_accuracy``) but the template has
    no proxy oracle.
    """
    objectives = tuple(objectives)
    cons = constraints or Constraints()
    needs_acc = "accuracy" in objectives or bool(cons.min_accuracy)
    if needs_acc and not template.supports_accuracy:
        raise ValueError(
            "accuracy objective/constraint requires a tensor proxy "
            "accuracy oracle (ProxyAccuracy.proxy_arrays); measured oracles "
            "must use the NumPy 'nsga2' strategy")
    L, K = template.L, template.n_cuts
    n_plat = template.cost_prefix.shape[0]
    has_acc = template.supports_accuracy

    def eval_cuts(C: Tensor, t: EvalTables) -> Tuple[Tensor, Tensor]:
        dev = t.device
        C = torch.clamp(C.to(device=dev, dtype=torch.int64), min=-1)
        n = C.shape[0]
        bounds = torch.cat(
            [torch.full((n, 1), -1, dtype=torch.int64, device=dev), C,
             torch.full((n, 1), L - 1, dtype=torch.int64, device=dev)],
            dim=1)                                            # (N, P+1)
        a = bounds[:, :-1] + 1                                # (N, P)
        b1 = bounds[:, 1:] + 1
        prow = torch.arange(n_plat, device=dev)[None, :]
        stage_lat = (t.cost_prefix[prow, 0, b1]
                     - t.cost_prefix[prow, 0, a])             # (N, P)
        energy = (t.cost_prefix[prow, 1, b1]
                  - t.cost_prefix[prow, 1, a]).sum(dim=1)     # (N,)

        if K:
            p = C                                             # (N, K)
            sent = bounds[:, 1:K + 1] > bounds[:, :K]
            remaining = bounds[:, -1:] > bounds[:, 1:K + 1]
            active = (p >= 0) & (p < L - 1) & sent & remaining
            raw = (torch.ceil(t.cut_elems[torch.clamp(p, 0, max(L - 2, 0))]
                              * t.producer_bpe[None, :]) * t.batch)
            nbytes = torch.where(active, raw, 0.0)            # (N, K)
            packets = torch.ceil(nbytes / t.link_payload[None, :])
            wire_bits = (nbytes + packets * t.link_header[None, :]) * 8.0
            link_lat = torch.where(
                nbytes > 0,
                t.link_setup[None, :] + wire_bits / t.link_rate[None, :], 0.0)
            energy = energy + torch.where(
                nbytes > 0, t.link_power[None, :] * link_lat
                + t.link_e_byte[None, :] * nbytes, 0.0).sum(dim=1)
            max_link = nbytes.max(dim=1).values
        else:
            link_lat = torch.zeros((n, 1), device=dev)
            max_link = torch.zeros(n, device=dev)

        latency = stage_lat.sum(dim=1) + link_lat.sum(dim=1)
        mods = torch.cat([stage_lat, link_lat], dim=1)
        slowest = torch.where(mods > 0, mods, 0.0).max(dim=1).values
        throughput = torch.where(slowest > 0, 1.0 / slowest, 0.0)

        aa_raw, bb_raw = a, bounds[:, 1:]
        valid = aa_raw <= bb_raw
        aa = torch.where(valid, aa_raw, 0)
        bb = torch.where(valid, bb_raw, 0)
        mems = _segment_memory(t, aa, bb, valid)              # (N, P)

        if has_acc:
            wpre = t.acc_weight_prefix
            loss = (t.acc_noise[None, :]
                    * (wpre[bounds[:, 1:] + 1] - wpre[bounds[:, :-1] + 1])
                    ).sum(dim=1)
            acc = torch.clamp(t.acc_base - t.acc_scale * loss, min=0.0)
        else:
            acc = torch.ones(n, device=dev)

        over = mems - t.capacity[None, :]
        cv = torch.where(over > 0, over / t.capacity[None, :], 0.0).sum(dim=1)
        if cons.max_link_bytes:
            o = max_link - cons.max_link_bytes
            cv = cv + torch.where(o > 0, o / cons.max_link_bytes, 0.0)
        if cons.min_accuracy:
            cv = cv + torch.clamp(cons.min_accuracy - acc, min=0.0)
        if cons.max_latency_s:
            o = latency - cons.max_latency_s
            cv = cv + torch.where(o > 0, o / cons.max_latency_s, 0.0)
        if cons.max_energy_j:
            o = energy - cons.max_energy_j
            cv = cv + torch.where(o > 0, o / cons.max_energy_j, 0.0)
        if cons.min_throughput:
            s = cons.min_throughput - throughput
            cv = cv + torch.where(s > 0, s / cons.min_throughput, 0.0)

        cols = {
            "latency": latency,
            "energy": energy,
            "throughput": -throughput,
            "bandwidth": max_link,
            "memory": mems.max(dim=1).values,
            "accuracy": -acc,
        }
        F = torch.stack([cols[k] for k in objectives], dim=1)
        return F, cv

    return eval_cuts


def make_batch_eval_fn(tables: EvalTables, objectives: Sequence[str],
                       constraints: Optional[Constraints] = None,
                       ) -> Callable[[Tensor], Tuple[Tensor, Tensor]]:
    """Build ``eval(C) -> (F, CV)`` over an (N, n_cuts) sorted cut matrix,
    with ``tables`` bound (use :func:`make_runtime_eval_fn` when the same
    function must serve drifting table values)."""
    fn = make_runtime_eval_fn(tables, objectives, constraints)

    def eval_cuts(C: Tensor) -> Tuple[Tensor, Tensor]:
        return fn(C, tables)

    return eval_cuts
