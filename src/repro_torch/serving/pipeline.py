"""Partitioned (multi-platform) inference execution — the paper's
Definition 1 acted out: stage k runs its contiguous range of blocks, and
the bytes of the activation crossing each link are counted.

:class:`PartitionedCNNRunner` runs a CNN stage at its platform's precision
(the stage's weights fake-quantized to its bit width) and quantizes the
activation crossing each link to the producer's width: the measured-
accuracy oracle of the explorer (``quantize.evaluate``).
:class:`PartitionedLMRunner` splits a decoder LM the same way, each
stage's weights calibrated over the stage's stacked layers, as the
reference calibrates them, and a mixed-family LM (Granite 4.0-H) or a
moe-family LM (DeepSeek-V3) at the search's own positions, a stage
boundary falling between a layer's mixer (or attention) and its MLP or
expert layer too.

On one device the stages run in turn; the throughput model (Def. 4) comes
from per-stage timings.  With quantization off the partitioned output
equals the monolithic model's.  The serve runtime (``repro_torch.serve``)
drives each LM stage on its own through ``stage_step_fn``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.func import functional_call

import torch.nn.functional as F

from repro_torch.core.quant import (QuantSpec, quantize_leaves,
                                    quantize_modules, quantize_tensor)
from repro_torch.models.decoder import (run_blocks, stacked_caches,
                                        step_positions)
from repro_torch.nn.layers import rms_norm
from repro_torch.nn.ssm import Mamba2Mixer
from repro_torch.obs.handle import NOOP_OBS, Obs
from repro_torch.serving.engine import sync

TRACK = "oracle"     # the partitioned runners' spans' track
# counters .cuda / .ref: MBConv blocks run, by their depthwise unit's route
MBCONV_DW = "mbconv_dw"
SSM_SCAN_CALLS = "ssm_scan_calls"   # counters .cuda / .ref: Mamba2 scans
# families split at the search's positions, over ``model.units()``
CHAIN_FAMILIES = ("mixed", "moe")

def def4_throughput(stage_latencies: Sequence[float],
                    link_latencies: Sequence[float] = ()) -> float:
    """Def. 4: steady-state pipeline throughput is set by the slowest
    module — ``1 / max(stage latencies, link latencies)``."""
    mods = [t for t in list(stage_latencies) + list(link_latencies) if t > 0]
    return 1.0 / max(mods) if mods else 0.0


@dataclasses.dataclass
class StageReport:
    latency_s: List[float]
    link_bytes: List[int]

    def throughput(self, link_latency_s: Optional[List[float]] = None) -> float:
        """Def. 4 with measured stage latencies."""
        return def4_throughput(self.latency_s, link_latency_s or ())


def pipeline_report(stage_latencies: Sequence[float],
                    link_latencies: Sequence[float]) -> Dict[str, float]:
    lat = sum(stage_latencies) + sum(link_latencies)
    return {"latency_s": lat,
            "throughput": def4_throughput(stage_latencies, link_latencies)}


def link_transfer_bytes(n_elems: int, spec: Optional[QuantSpec]) -> int:
    """Bytes shipped over a link for ``n_elems`` activations quantized to the
    producer's bit width (float32 when unquantized).  Sub-byte widths use
    fractional bytes-per-element — ``bits // 8`` would report 0 bytes for
    4-bit links."""
    if spec is None:
        return int(n_elems * 4)
    return int(math.ceil(n_elems * spec.bits / 8))


class PartitionedCNNRunner:
    """Split a ``CNNModel`` at block boundaries across platforms.

    ``cuts=[b]`` puts a stage boundary after block ``b``.  A stage with a
    ``QuantSpec`` runs on fake-quantized copies of its blocks' parameters
    (``quantize_modules``, one call a stage: on the card one launch pair
    of K7 for all its blocks' leaves; the model's own weights stay float),
    a stage without one on the model's weights; BatchNorm statistics are
    the model's buffers either way.  The activation leaving a quantized
    stage is fake-quantized to its width (``quantize_tensor``, per tensor:
    K7 as a one-tensor call), as it would cross the link.

    ``obs`` (default off, :data:`~repro_torch.obs.NOOP_OBS`): switched on,
    the runner records on the ``oracle`` track one ``oracle.quantize`` a
    stage as it is built (``stage``, ``bits``: None for the model's own
    weights, ``tensors`` quantized), and in :meth:`run` one
    ``oracle.stage`` a stage (on the two clock reads that time it) and one
    ``oracle.link`` a link fake-quant (``bytes``), and counts the tensors
    it fake-quantizes, weights and links, in ``fake_quant_tensors.cuda``
    (K7) or ``fake_quant_tensors.ref`` (the chain), by the route
    :func:`~repro_torch.core.quant.quantize_tensors` takes, and the MBConv
    blocks it runs in ``mbconv_dw.cuda`` (their depthwise unit through
    K8) or ``mbconv_dw.ref`` (the chain of ops), by the block's
    ``dw_route``.
    """

    def __init__(self, model, cuts: Sequence[int],
                 quant_specs: Optional[Sequence[Optional[QuantSpec]]] = None,
                 obs: Optional[Obs] = None):
        self.obs = obs = NOOP_OBS if obs is None else obs
        self.model = model
        self.cuts = list(cuts)
        n_stages = len(self.cuts) + 1
        self.quant_specs = (list(quant_specs) if quant_specs
                            else [None] * n_stages)
        if len(self.quant_specs) != n_stages:
            raise ValueError(f"{len(self.quant_specs)} quant specs for "
                             f"{n_stages} stages")
        bounds = [0] + [c + 1 for c in self.cuts] + [len(model.blocks)]
        self.stage_blocks = [model.blocks[a:b]
                             for a, b in zip(bounds, bounds[1:])]
        # per stage, per block: its fake-quantized parameters, or None for
        # the model's own
        self.stage_params = []
        with torch.no_grad():
            for i, (blocks, spec) in enumerate(zip(self.stage_blocks,
                                                   self.quant_specs)):
                if obs.enabled:
                    t0 = time.perf_counter()
                params = ([None] * len(blocks) if spec is None
                          else quantize_modules([b for _, b in blocks], spec,
                                                obs=obs))
                self.stage_params.append(params)
                if obs.enabled:
                    obs.tracer.complete(
                        "oracle.quantize", track=TRACK, start=t0,
                        end=time.perf_counter(),
                        args={"stage": i,
                              "bits": None if spec is None else spec.bits,
                              "tensors": sum(len(p) for p in params
                                             if p is not None)})

    @property
    def n_stages(self) -> int:
        """The number of stages (cuts + 1)."""
        return len(self.stage_blocks)

    def _run_stage(self, i: int, x: torch.Tensor) -> torch.Tensor:
        for (_, b), p in zip(self.stage_blocks[i], self.stage_params[i]):
            if self.obs.enabled and hasattr(b, "dw_route"):
                self.obs.metrics.counter(
                    f"{MBCONV_DW}.{b.dw_route(x)}").inc()
            x = b(x) if p is None else functional_call(b, p, (x,))
        return x

    @torch.no_grad()
    def run(self, x: torch.Tensor, time_stages: bool = False
            ) -> Tuple[torch.Tensor, StageReport]:
        """Logits of the NCHW batch ``x`` through the stages in turn, with
        each stage's wall time (waiting for the device when
        ``time_stages``) and the bytes each link carries."""
        dev, obs = self.model.device, self.obs
        lat, link_bytes = [], []
        for i in range(self.n_stages):
            t0 = time.perf_counter()
            x = self._run_stage(i, x)
            if time_stages:
                sync(dev)
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            if obs.enabled:
                obs.tracer.complete("oracle.stage", track=TRACK, start=t0,
                                    end=t1)
            if i < self.n_stages - 1:
                spec = self.quant_specs[i]
                link_bytes.append(link_transfer_bytes(x.numel(), spec))
                if spec is not None:
                    x = quantize_tensor(x, spec, obs=obs)   # over the link
                    if obs.enabled:
                        obs.tracer.complete(
                            "oracle.link", track=TRACK, start=t1,
                            end=time.perf_counter(),
                            args={"bytes": link_bytes[-1]})
        return x, StageReport(lat, link_bytes)


class _UnitTimer:
    """One unit's time, read after the stage's sync: CUDA events on a CUDA
    device (no synchronisation of their own), else the host clock (the
    CPU runs in order)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            self.end.record()
        else:
            self.t1 = time.perf_counter()

    def ms(self) -> float:
        """Milliseconds between start and stop (after a sync on CUDA)."""
        if self.cuda:
            return self.start.elapsed_time(self.end)
        return 1e3 * (self.t1 - self.t0)


class QuantizedBlock:
    """A block run on other parameters (``torch.func.functional_call``):
    called as the block is, so ``run_blocks`` takes it in the block's
    place."""

    def __init__(self, block: torch.nn.Module, params: Dict[str, torch.Tensor]):
        self.block, self.params = block, params

    def __call__(self, x, **kw):
        return functional_call(self.block, self.params, (x,), kw)


def quantized_units(units: Sequence[torch.nn.Module], spec: QuantSpec,
                    obs: Obs = NOOP_OBS) -> List[QuantizedBlock]:
    """``units`` (blocks, or a mixed model's mixer and MLP units) on
    fake-quantized copies of their parameters, calibrated as the reference
    calibrates a stage: each parameter stacked over the units of its kind
    (their ``kind``) and quantized whole, so a per-tensor range spans all
    of them, and the stacked one-dimensional leaves (norm scales, now
    (L, d)) are quantized too.  The stage's stacked leaves are quantized
    in one :func:`~repro_torch.core.quant.quantize_leaves` call (one
    launch pair of K7 on the card; ``obs`` counts them), so during it the
    stage's stacks and the one buffer of their results are alive together,
    twice the bytes of the stage's weights beside the model's own."""
    params: List[Dict[str, torch.Tensor]] = [{} for _ in units]
    by_kind: Dict[object, List[int]] = {}
    for i, u in enumerate(units):
        by_kind.setdefault(getattr(u, "kind", None), []).append(i)
    slots, stacked = [], []
    for idx in by_kind.values():
        named = [dict(units[i].named_parameters()) for i in idx]
        for name in named[0]:
            slots.append((idx, name))
            stacked.append(torch.stack([p[name] for p in named]))
    for (idx, name), q in zip(slots, quantize_leaves(stacked, spec,
                                                     obs=obs)):
        for i, t in zip(idx, q.unbind(0)):
            params[i][name] = t
    return [QuantizedBlock(u, p) for u, p in zip(units, params)]


class PartitionedLMRunner:
    """Split an LM into pipeline stages.

    A ``DecoderLM`` (dense, vlm, audio) is split at block boundaries:
    ``cuts=[b]`` puts a stage boundary after block ``b``; stage 0 owns the
    embedding, the last stage owns the final norm and the head.  A stage
    without a ``QuantSpec`` shares the model's weights (``blocks[a:b]``, no
    copies); a stage with one runs on fake-quantized copies of its blocks'
    parameters (:func:`quantized_units`: every stacked leaf of the
    reference's ``blocks_dense``, sliced to the stage's layers and
    quantized whole; the model's own weights stay
    float, the embedding and the head are not quantized, as in the
    reference).  Those copies are a snapshot of the weights when the runner
    is built: a model trained or loaded afterwards changes its float
    stages only, so build a new runner after it.  With ``link_quant`` the
    activation leaving a quantized
    stage is fake-quantized to its width (per tensor), as it would cross
    the link.  It takes the dense, vlm and audio families block by block,
    as the reference's runner does; stage 0 embeds the batch by family
    (``DecoderLM.embed_batch``: codebooks, vision embeddings, M-RoPE
    positions).

    A ``MixedLM`` (the mixed family) or a moe-family ``DecoderLM`` is
    split at the search's own positions: ``cuts`` is a cut vector over
    the model's chain (``model.units()``, the nodes of ``to_graph``:
    position 0 the embedding, 1 .. 2L each layer's mixer or attention unit
    and its MLP or expert unit, 2L + 1 the head), read as the cost model
    reads it: platform k holds the positions ``cuts[k-1] + 1 .. cuts[k]``
    (-1: none before it), so a cut after a mixer puts that layer's MLP on
    the next stage, and a platform that holds nothing drops out with its
    spec.  A quantized stage's units are :func:`quantized_units`, each
    leaf stacked over the stage's units of one kind (Mamba2 mixers,
    attention mixers, MLA units, MLPs, expert units: their held experts'
    leaves stacked (L, H, ...), the correction bias (L, E) of the
    ``noaux_tc`` route too); the embedding and the head stay float, and
    the head runs in the last stage.  ``quant_specs`` has one entry a
    platform.

    ``impl`` is passed to every block or unit (``"cuda"``/``"auto"``: the
    kernels on a CUDA tensor).  ``obs`` (default off,
    :data:`~repro_torch.obs.NOOP_OBS`): switched on, a chain runner (mixed
    or moe family) records on the ``oracle`` track one ``oracle.quantize``
    a stage as it is built (``stage``, ``bits``, ``tensors``), and in
    :meth:`forward` one ``oracle.stage`` a stage (``stage``, ``mamba``,
    ``attention``: the mixers it holds, ``tokens``; with experts also
    ``moe``, the expert units it holds, and ``moe_ms``, their time: CUDA
    events read after the stage's sync on a card, the host clock
    elsewhere; with MLA also ``mla``, the MLA units it holds, and
    ``mla_ms``, their time, read alike) and one
    ``oracle.link`` a link fake-quant (``bytes``), and counts each Mamba2
    mixer's scan in ``ssm_scan_calls.cuda`` (the kernel) or
    ``ssm_scan_calls.ref``, the tensors it fake-quantizes, stacked leaves
    and links, in ``fake_quant_tensors.cuda`` (K7) or
    ``fake_quant_tensors.ref``, and (the expert units, given ``obs``) the
    rows the held experts computed and the tokens x top-k in
    ``moe_rows.held`` and ``moe_rows.routed``.
    """

    def __init__(self, model, cuts: Sequence[int],
                 quant_specs: Optional[Sequence[Optional[QuantSpec]]] = None,
                 link_quant: bool = False, *, impl: str = "ref",
                 obs: Optional[Obs] = None):
        cfg = model.cfg
        if cfg.family not in ("dense", "vlm", "audio") + CHAIN_FAMILIES:
            raise ValueError(f"{cfg.arch_id}: the LM pipeline runner "
                             f"supports homogeneous block stacks and the "
                             f"mixed and moe families' chains, not the "
                             f"{cfg.family} family")
        self.model = model
        self.cuts = list(cuts)
        self.link_quant = link_quant
        self.impl = impl
        self.obs = NOOP_OBS if obs is None else obs
        if cfg.family in CHAIN_FAMILIES:
            self._init_chain(quant_specs)
            return
        bounds = [0] + [c + 1 for c in self.cuts] + [cfg.n_layers]
        self.ranges = list(zip(bounds, bounds[1:]))
        self.quant_specs = (list(quant_specs) if quant_specs
                            else [None] * self.n_stages)
        if len(self.quant_specs) != self.n_stages:
            raise ValueError(f"{len(self.quant_specs)} quant specs for "
                             f"{self.n_stages} stages")
        with torch.no_grad():
            self._blocks = [
                model.blocks[a:b] if spec is None
                else quantized_units(model.blocks[a:b], spec, self.obs)
                for (a, b), spec in zip(self.ranges, self.quant_specs)]

    def _init_chain(self, quant_specs) -> None:
        """A chain model's stages: ``ranges`` over ``model.units()``, the
        platforms that hold a node and their specs."""
        units = self.model.units()
        head = len(units) + 1
        n_plat = len(self.cuts) + 1
        specs = list(quant_specs) if quant_specs else [None] * n_plat
        if len(specs) != n_plat:
            raise ValueError(f"{len(specs)} quant specs for {n_plat} "
                             f"platforms")
        if any(not -1 <= c <= head for c in self.cuts) or \
                self.cuts != sorted(self.cuts):
            raise ValueError(f"cuts {self.cuts} are not sorted positions "
                             f"in -1 .. {head}")
        bounds = [-1] + self.cuts + [head]
        held = [(bounds[k] + 1, bounds[k + 1], spec)
                for k, spec in enumerate(specs) if bounds[k + 1] > bounds[k]]
        self.quant_specs = [spec for _, _, spec in held]
        # units of positions a .. b: indices max(a, 1) - 1 .. min(b, 2L) - 1
        self.ranges = [(max(a, 1) - 1, min(b, head - 1))
                       for a, b, _ in held]
        self._kinds = [[u.kind for u in units[a:b]] for a, b in self.ranges]
        self._blocks = []
        obs = self.obs
        with torch.no_grad():
            for si, ((a, b), spec) in enumerate(zip(self.ranges,
                                                    self.quant_specs)):
                if obs.enabled:
                    t0 = time.perf_counter()
                blocks = (units[a:b] if spec is None
                          else quantized_units(units[a:b], spec, obs))
                self._blocks.append(blocks)
                if obs.enabled:
                    obs.tracer.complete(
                        "oracle.quantize", track=TRACK, start=t0,
                        end=time.perf_counter(),
                        args={"stage": si,
                              "bits": None if spec is None else spec.bits,
                              "tensors": 0 if spec is None else sum(
                                  len(q.params) for q in blocks)})

    @property
    def n_stages(self) -> int:
        """The number of stages (cuts + 1)."""
        return len(self.ranges)

    @torch.no_grad()
    def forward(self, batch) -> Tuple[torch.Tensor, StageReport]:
        """Logits of ``batch`` through the stages in turn, with each
        stage's wall time (embedding in stage 0; the head in none, as the
        reference times it, but in the last stage for a chain, where the
        cost model puts it) and the bytes each link carries at the
        producing stage's width."""
        m = self.model
        if m.cfg.family in CHAIN_FAMILIES:
            return self._forward_chain(batch)
        dev = m.device
        lat, link_bytes = [], []
        t0 = time.perf_counter()
        x, positions = m.embed_batch(batch)
        for si, blocks in enumerate(self._blocks):
            x, _, _ = run_blocks(blocks, x, positions, impl=self.impl)
            sync(dev)
            lat.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            if si < self.n_stages - 1:
                spec = self.quant_specs[si]
                link_bytes.append(link_transfer_bytes(x.numel(), spec))
                if self.link_quant and spec is not None:
                    x = quantize_tensor(x, spec, obs=self.obs)  # the link
        return m.head_logits(x), StageReport(lat, link_bytes)

    def _forward_chain(self, batch) -> Tuple[torch.Tensor, StageReport]:
        m, obs = self.model, self.obs
        lat, link_bytes = [], []
        last = self.n_stages - 1
        experts, mla = bool(m.cfg.n_experts), m.cfg.use_mla
        x = positions = None
        for si, blocks in enumerate(self._blocks):
            t0 = time.perf_counter()
            if si == 0:
                x, positions = m.embed_tokens(batch)
            kinds = self._kinds[si]
            times = {"moe": [], "mla": []}
            for unit, kind in zip(blocks, kinds):
                if kind == "mamba" and obs.enabled:
                    obs.metrics.counter(
                        f"{SSM_SCAN_CALLS}."
                        f"{Mamba2Mixer.scan_impl(x, self.impl)}").inc()
                timer = (_UnitTimer(x.device)
                         if kind in times and obs.enabled else None)
                x = unit(x, positions=positions, impl=self.impl, obs=obs)
                if timer is not None:
                    timer.stop()
                    times[kind].append(timer)
            if si == last:
                x = m.head_logits(x)
            sync(m.device)
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            if obs.enabled:
                args = {"stage": si, "mamba": kinds.count("mamba"),
                        "attention": kinds.count("attention"),
                        "tokens": x.shape[0] * x.shape[1]}
                for kind, on in (("moe", experts), ("mla", mla)):
                    if on:
                        args[kind] = kinds.count(kind)
                        args[f"{kind}_ms"] = sum(
                            (t.ms() for t in times[kind]), 0.0)
                obs.tracer.complete("oracle.stage", track=TRACK, start=t0,
                                    end=t1, args=args)
            if si < last:
                spec = self.quant_specs[si]
                link_bytes.append(link_transfer_bytes(x.numel(), spec))
                if self.link_quant and spec is not None:
                    x = quantize_tensor(x, spec, obs=obs)   # over the link
                    if obs.enabled:
                        obs.tracer.complete(
                            "oracle.link", track=TRACK, start=t1,
                            end=time.perf_counter(),
                            args={"bytes": link_bytes[-1]})
        return x, StageReport(lat, link_bytes)

    def stage_weights(self, si: int) -> Dict:
        """What stage ``si`` owns: its blocks (on their fake-quantized
        parameters when the stage has a ``QuantSpec``), plus the embedding
        on stage 0 and the final norm + head on the last stage (the
        embedding again when tied)."""
        m, cfg = self.model, self.model.cfg
        w = {"blocks": self._blocks[si]}
        last = si == self.n_stages - 1
        if si == 0 or (last and cfg.tied_embeddings):
            w["embed"] = m.embed
        if last:
            w["final_norm"] = m.final_norm
            if not cfg.tied_embeddings:
                w["head"] = m.head
        return w

    def init_stage_caches(self, si: int, batch: int, capacity: int,
                          dtype=torch.float32, lanes: bool = False) -> Dict:
        """Fresh decode caches for stage ``si``'s block range (leading
        block axis, ``pos`` = 0); ``lanes``: one write position per batch
        row, ``pos`` (blocks, batch)."""
        a, b = self.ranges[si]
        return stacked_caches(self.model.cfg, b - a, batch, capacity, dtype,
                              self.model.device, lanes)

    def stage_step_fn(self, si: int):
        """``(weights, caches, x) -> (out, new_caches)`` for one prefill or
        decode step of stage ``si`` (the serve runtime's execution layer),
        over ``stage_weights(si)`` and caches of ``init_stage_caches(si,
        ...)``, which it writes in place.

        Stage 0 takes ``x`` as integer tokens (B, T) and embeds them; later
        stages take the predecessor's activations (B, T, D).  The last
        stage applies the final norm and the head and returns logits.
        Token positions continue from the caches' write position exactly
        as in ``DecoderLM.decode_step`` — each lane's own with lane caches,
        so lanes admitted at different times decode at their own positions,
        and a step over every lane is one call.  The step runs under
        ``torch.no_grad()`` (grad mode is per thread, and the serve
        runtime calls it from its stage threads).
        """
        cfg = self.model.cfg
        if cfg.family != "dense":
            raise NotImplementedError(
                "step-wise stage serving supports dense decoder stacks")
        a, b = self.ranges[si]
        if b <= a:
            raise ValueError(f"stage {si} owns no blocks (cuts {self.cuts})")
        first, last = si == 0, si == self.n_stages - 1
        tied = cfg.tied_embeddings

        @torch.no_grad()
        def fn(weights, caches, x):
            if first:
                x = F.embedding(x, weights["embed"])
            bsz, t, _ = x.shape
            positions = step_positions(caches["pos"][0], bsz, t, x.device)
            x, new_caches, _ = run_blocks(weights["blocks"], x, positions,
                                          caches=caches)
            if last:
                x = rms_norm(x, weights["final_norm"], cfg.norm_eps)
                x = x @ (weights["embed"].T if tied else weights["head"])
            return x, new_caches
        return fn
