"""Partitioned (multi-platform) inference execution — the paper's
Definition 1 acted out: stage k runs its contiguous range of blocks, and
the bytes of the activation crossing each link are counted.

:class:`PartitionedCNNRunner` runs a CNN stage at its platform's precision
(the stage's weights fake-quantized to its bit width) and quantizes the
activation crossing each link to the producer's width: the measured-
accuracy oracle of the explorer (``quantize.evaluate``).
:class:`PartitionedLMRunner` splits a decoder LM the same way, each
stage's weights calibrated over the stage's stacked layers, as the
reference calibrates them.

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

from repro_torch.core.quant import (QuantSpec, quantize_leaf,
                                    quantize_pytree, quantize_tensor)
from repro_torch.models.convert import reference_leaves
from repro_torch.models.decoder import (run_blocks, stacked_caches,
                                        step_positions)
from repro_torch.nn.layers import rms_norm
from repro_torch.obs.handle import NOOP_OBS, Obs
from repro_torch.serving.engine import sync

TRACK = "oracle"     # PartitionedCNNRunner's spans' track


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
    (``quantize_pytree``; the model's own weights stay float), a stage
    without one on the model's weights; BatchNorm statistics are the
    model's buffers either way.  The activation leaving a quantized stage
    is fake-quantized to its width (``quantize_tensor``, per tensor), as
    it would cross the link.

    ``obs`` (default off, :data:`~repro_torch.obs.NOOP_OBS`): switched on,
    the runner records on the ``oracle`` track one ``oracle.quantize`` a
    stage as it is built (``stage``, ``bits``: None for the model's own
    weights, ``tensors`` quantized), and in :meth:`run` one
    ``oracle.stage`` a stage (on the two clock reads that time it) and one
    ``oracle.link`` a link fake-quant (``bytes``).
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
                params = [None if spec is None else quantize_pytree(b, spec)
                          for _, b in blocks]
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
                    x = quantize_tensor(x, spec)    # fake-quant over the link
                    if obs.enabled:
                        obs.tracer.complete(
                            "oracle.link", track=TRACK, start=t1,
                            end=time.perf_counter(),
                            args={"bytes": link_bytes[-1]})
        return x, StageReport(lat, link_bytes)


class QuantizedBlock:
    """A block run on other parameters (``torch.func.functional_call``):
    called as the block is, so ``run_blocks`` takes it in the block's
    place."""

    def __init__(self, block: torch.nn.Module, params: Dict[str, torch.Tensor]):
        self.block, self.params = block, params

    def __call__(self, x, **kw):
        return functional_call(self.block, self.params, (x,), kw)


def quantized_blocks(model, a: int, b: int, spec: QuantSpec
                     ) -> List[QuantizedBlock]:
    """Blocks ``a:b`` of ``model`` on fake-quantized copies of their
    parameters, calibrated as the reference calibrates a stage: every
    stacked leaf (``models.convert.reference_leaves``) sliced to the
    stage's layers and quantized whole, so a per-tensor range spans all of
    them, and the stacked norm scales, now (L, d), are quantized too."""
    params: List[Dict[str, torch.Tensor]] = [{} for _ in range(b - a)]
    for key, leaf in reference_leaves(model).items():
        if not key.startswith("blocks_dense/"):
            continue
        name = key.partition("/")[2].replace("/", ".")
        q = quantize_leaf(torch.stack(leaf.params[a:b]), spec)
        for i, t in enumerate(q.unbind(0)):
            params[i][name] = t
    return [QuantizedBlock(blk, p)
            for blk, p in zip(model.blocks[a:b], params)]


class PartitionedLMRunner:
    """Split a ``DecoderLM`` at block boundaries (pipeline stages).

    ``cuts=[b]`` puts a stage boundary after block ``b``.  Stage 0 owns the
    embedding, the last stage owns the final norm and the head.  A stage
    without a ``QuantSpec`` shares the model's weights (``blocks[a:b]``, no
    copies); a stage with one runs on fake-quantized copies of its blocks'
    parameters (:func:`quantized_blocks`; the model's own weights stay
    float, the embedding and the head are not quantized, as in the
    reference).  Those copies are a snapshot of the weights when the runner
    is built: a model trained or loaded afterwards changes its float
    stages only, so build a new runner after it.  With ``link_quant`` the
    activation leaving a quantized
    stage is fake-quantized to its width (per tensor), as it would cross
    the link.  It takes the dense, vlm and audio families, as the
    reference's runner does, and a moe model raises as there; stage 0
    embeds the batch by family (``DecoderLM.embed_batch``: codebooks,
    vision embeddings, M-RoPE positions).
    """

    def __init__(self, model, cuts: Sequence[int],
                 quant_specs: Optional[Sequence[Optional[QuantSpec]]] = None,
                 link_quant: bool = False):
        cfg = model.cfg
        if cfg.family not in ("dense", "vlm", "audio"):
            raise ValueError(f"{cfg.arch_id}: the LM pipeline runner "
                             f"supports homogeneous block stacks, not the "
                             f"{cfg.family} family")
        self.model = model
        self.cuts = list(cuts)
        bounds = [0] + [c + 1 for c in self.cuts] + [cfg.n_layers]
        self.ranges = list(zip(bounds, bounds[1:]))
        self.quant_specs = (list(quant_specs) if quant_specs
                            else [None] * self.n_stages)
        if len(self.quant_specs) != self.n_stages:
            raise ValueError(f"{len(self.quant_specs)} quant specs for "
                             f"{self.n_stages} stages")
        self.link_quant = link_quant
        with torch.no_grad():
            self._blocks = [
                model.blocks[a:b] if spec is None
                else quantized_blocks(model, a, b, spec)
                for (a, b), spec in zip(self.ranges, self.quant_specs)]

    @property
    def n_stages(self) -> int:
        """The number of stages (cuts + 1)."""
        return len(self.ranges)

    @torch.no_grad()
    def forward(self, batch) -> Tuple[torch.Tensor, StageReport]:
        """Logits of ``batch`` through the stages in turn, with each
        stage's wall time (embedding in stage 0, head in none: as the
        reference times it) and the bytes each link carries at the
        producing stage's width."""
        m = self.model
        dev = m.device
        lat, link_bytes = [], []
        t0 = time.perf_counter()
        x, positions = m.embed_batch(batch)
        for si, blocks in enumerate(self._blocks):
            x, _, _ = run_blocks(blocks, x, positions)
            sync(dev)
            lat.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            if si < self.n_stages - 1:
                spec = self.quant_specs[si]
                link_bytes.append(link_transfer_bytes(x.numel(), spec))
                if self.link_quant and spec is not None:
                    x = quantize_tensor(x, spec)    # fake-quant over the link
        return m.head_logits(x), StageReport(lat, link_bytes)

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
                x = rms_norm(x, weights["final_norm"])
                x = x @ (weights["embed"].T if tied else weights["head"])
            return x, new_caches
        return fn
