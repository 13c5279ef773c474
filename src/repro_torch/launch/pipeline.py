"""Pipeline parallelism over a stage axis — the paper's partitioning run as
a GPipe schedule (the JAX package's ``repro.launch.pipeline``).

The explorer (``repro_torch.core``) picks the stage boundary; for a
homogeneous transformer stack on identical stages the latency-balanced
Def.-2 optimum is the equal split (:func:`explorer_stage_boundary` asks
the explorer).  The layer stack is split into S contiguous stages of L/S
blocks (:func:`stack_stages`), and microbatches pass stage to stage
(:func:`pipelined_apply`): at step s, stage k takes microbatch s - k, for
M + S - 1 steps.  Each handoff is exactly the paper's link tensor
(b_mb, T, d_model).

The reference runs the stages on the pods of its mesh, one per pod,
handing off with ``lax.ppermute``.  Here each stage runs on its own CUDA
stream, on the device the mesh's stage axis gives it (on one card every
stage shares ``cuda:0``, so the stages share its SMs and the schedule's
bubble shows as idle stream time); a handoff is ordered by an event
recorded on the producing stage's stream, not by a synchronize.  On the
CPU (tests) the stages run one after the other in the same order.

``pipelined_apply`` matches the monolithic model's logits (tested),
embedding, final norm and head running outside the pipelined stack.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.decoder import DecoderBlock, DecoderLM, run_blocks
from repro_torch.nn.sharding import Mesh

PIPELINED_FAMILIES = ("dense", "audio", "vlm")


def stack_stages(model: DecoderLM, n_stages: int
                 ) -> List[List[DecoderBlock]]:
    """The model's blocks as ``n_stages`` contiguous stages of L/S blocks
    each (the reference's reshape (L, ...) -> (S, L/S, ...) of its stacked
    leaves); the blocks themselves, no weight copied.  Raises
    ``ValueError`` for a family whose stack the pipeline does not run
    (a moe model: the reference pipelines ``blocks_dense`` only)."""
    _check_family(model.cfg)
    blocks = list(model.blocks)
    n = len(blocks)
    if n % n_stages:
        raise ValueError(f"{n} blocks do not split into {n_stages} stages")
    per = n // n_stages
    return [blocks[k * per:(k + 1) * per] for k in range(n_stages)]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PIPELINED_FAMILIES:
        raise ValueError(f"{cfg.arch_id}: the pipeline runs the "
                         f"{', '.join(PIPELINED_FAMILIES)} families, not "
                         f"{cfg.family!r}")


def _split(t: torch.Tensor, n: int, axis: int) -> List[torch.Tensor]:
    b = t.shape[axis]
    if b % n:
        raise ValueError(f"batch {b} is not {n} microbatches")
    return list(t.split(b // n, dim=axis))


@torch.no_grad()
def pipelined_apply(model: DecoderLM, stages: Sequence[Sequence[DecoderBlock]],
                    batch, mesh: Mesh, n_microbatches: int,
                    stage_axis: str = "pod", impl: str = "auto"
                    ) -> torch.Tensor:
    """Forward pass with the layer stack pipelined over ``stage_axis``.

    ``stages``: :func:`stack_stages` of ``model`` at the mesh's stage-axis
    size.  Stage k runs on the k-th device of the stage axis, on a CUDA
    stream of its own there (one card: every stage on ``cuda:0``).  The
    batch's embeddings and positions are split into ``n_microbatches``
    along the batch axis; positions (3, B, T) (the vlm family's M-RoPE
    ids) are split along their batch axis, so every microbatch keeps its
    own (the reference's blocks get 2-D positions there, which M-RoPE
    refuses).  ``impl``: the blocks' attention (``"auto"``: the
    sliding-window kernel on a card, one launch per windowed block per
    microbatch; its plain version on the CPU)."""
    _check_family(model.cfg)
    n_stages = mesh.shape[stage_axis]
    if len(stages) != n_stages:
        raise ValueError(f"{len(stages)} stages for a stage axis of "
                         f"{n_stages}")
    devices = mesh.axis_devices(stage_axis)
    x, positions = model.embed_batch(batch)
    b, t, d = x.shape
    xs = _split(x, n_microbatches, 0)
    pos = _split(positions, n_microbatches, 1 if positions.dim() == 3 else 0)

    cuda = x.is_cuda
    streams = ([torch.cuda.Stream(device=dev) for dev in devices]
               if cuda else [None] * n_stages)
    ready = None
    if cuda:
        ready = torch.cuda.Event()
        ready.record()                      # the embedding, on this stream
    # handoff[k][m]: stage k's output of microbatch m and its event
    handoff: List[List[Tuple[torch.Tensor, object]]] = [
        [None] * n_microbatches for _ in range(n_stages)]
    for step in range(n_microbatches + n_stages - 1):
        for k in range(n_stages):
            m = step - k
            if not 0 <= m < n_microbatches:
                continue
            if k == 0:
                inp, event = xs[m], ready
            else:
                inp, event = handoff[k - 1][m]
            handoff[k][m] = _run_stage(stages[k], inp, pos[m], event,
                                       streams[k], devices[k], impl)
            if k:
                handoff[k - 1][m] = None    # the link tensor is consumed
    outs = []
    for y, event in handoff[-1]:
        if cuda:
            torch.cuda.current_stream().wait_event(event)
            y.record_stream(torch.cuda.current_stream())
        outs.append(y.to(x.device))
    return model.head_logits(torch.cat(outs, dim=0))


def _run_stage(blocks, inp, positions, event, stream, device, impl):
    """One stage on one microbatch: after ``event`` on ``stream`` (in
    order on the CPU), on ``device``; its output and the event after it."""
    if stream is None:
        y, _, _ = run_blocks(blocks, inp, positions, impl=impl)
        return y, None
    with torch.cuda.stream(stream):
        stream.wait_event(event)
        inp = inp.to(device, non_blocking=True)
        positions = positions.to(device, non_blocking=True)
        inp.record_stream(stream)
        positions.record_stream(stream)
        y, _, _ = run_blocks(blocks, inp, positions, impl=impl)
        done = torch.cuda.Event()
        done.record(stream)
    return y, done


def explorer_stage_boundary(cfg: ModelConfig, seq: int, n_stages: int,
                            link: str = "dci", device="cuda"
                            ) -> Tuple[list, object]:
    """Use the paper's explorer to choose the pipeline cut on TPU pods.

    Returns (cut layer indices, ExplorationResult).  For identical pods the
    Pareto-selected cut is the balanced split; heterogeneous pod mixes move
    it — both come from the same machinery.  The graph is the
    configuration's own (no weights are built); the search runs on
    ``device``.
    """
    from repro_torch.core import Platform, QuantSpec, SystemConfig, get_link
    from repro_torch.core.hwmodel.arch import TPU_V5E
    from repro_torch.explore import SearchSettings, explore_graph
    from repro_torch.models.registry import model_graph
    import dataclasses as dc

    graph = model_graph(cfg, seq)
    pod = Platform("pod", dc.replace(TPU_V5E, mem_bytes=256 * 16 * 2 ** 30),
                   QuantSpec(bits=16))
    system = SystemConfig([pod] * n_stages,
                          [get_link(link)] * (n_stages - 1))
    res = explore_graph(graph, system, objectives=("latency", "throughput"),
                        schedule_policy="insertion",
                        search=SearchSettings(seed=0), device=device)
    # map graph cut positions back to block indices (2 nodes per block:
    # attention + ffn, plus embed at 0)
    if res.selected is None:          # no feasible partition: balanced split
        step = max(1, cfg.n_layers // n_stages)
        return [min(cfg.n_layers - 1, (k + 1) * step - 1)
                for k in range(n_stages - 1)], res
    cuts = []
    for c in res.selected.cuts:
        layer = max(0, min(cfg.n_layers - 1, c // 2))
        cuts.append(layer)
    return cuts, res
