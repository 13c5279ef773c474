"""Serving driver — the paper-kind end-to-end example on the
``repro_torch.serve`` runtime (the JAX package's ``repro.launch.serve``).

Trains (briefly) a reduced model, lets the explorer pick the Def.-2 cut
for an embedded two-platform system, then serves a synthetic Poisson
traffic stream over partitioned stages with continuous batching:

  1. the explorer's schedule cut is snapped onto a decoder-block boundary
     (``repro_torch.explore.lm_block_cuts``) and feeds the serving config;
  2. N replicas of the async stage pipeline (thread-per-stage workers,
     emulated link wire time overlapped with compute) serve the stream
     behind a least-outstanding-slots router;
  3. the same burst through the lockstep serial-handoff baseline shows
     what pipelining buys (Def. 4), with per-request TTFT/latency
     percentiles from the router's merged report.

Everything runs on ``--device`` (the card by default; ``cpu`` for tests),
the search through ``torch_nsga2`` there; weights are drawn from a
generator seeded 0.  The serve path runs under ``torch.no_grad()``, so
the warm-trained model records no autograd graph while it serves.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --requests 16 --prompt-len 8 --max-new 12 --replicas 2
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List

import torch

from repro_torch.core import Platform, QuantSpec, SystemConfig, get_link
from repro_torch.core.hwmodel.arch import EYERISS_LIKE, SIMBA_LIKE
from repro_torch.data.synthetic import make_batch_for
from repro_torch.explore import SearchSettings, explore_graph, lm_block_cuts
from repro_torch.explore.runner import resolve_device
from repro_torch.models.registry import ARCH_IDS, build_model, get_config
from repro_torch.obs import NOOP_OBS, Obs, write_chrome_trace
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.serve import (PipelineServeEngine, ReplicaRouter, ServeLink,
                               poisson_traffic)
from repro_torch.serve.request import ServeReport
from repro_torch.serving.pipeline import PartitionedLMRunner
from repro_torch.training.train_lib import init_params, make_train_step


@dataclasses.dataclass
class ServeRun:
    """What :func:`run` leaves: the warm-trained model, the deployed block
    cuts, the async and serial runs' reports, the last warm step's loss,
    and whether either run dropped a request."""
    model: torch.nn.Module
    cuts: List[int]
    async_report: ServeReport
    serial_report: ServeReport
    warm_loss: float
    dropped: bool


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--rate-rps", type=float, default=200.0)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--link", default="eth10",
                    help="emulated inter-stage link (see repro_torch.core.link)")
    ap.add_argument("--warm-steps", type=int, default=30)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the async run "
                         "(open in Perfetto, or `python -m repro_torch.obs "
                         "PATH`)")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write a JSON metrics snapshot after the run")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train, search and serve on "
                         "(cpu for tests)")
    return ap.parse_args(argv)


def run(argv=None) -> ServeRun:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    obs = Obs.on() if (args.trace or args.metrics) else NOOP_OBS

    cfg = get_config(args.arch).reduced()
    if cfg.family not in ("dense",):
        raise SystemExit(f"--arch {args.arch}: partitioned serving needs a "
                         "dense decoder (block-boundary stage cuts)")
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))

    # brief warm training so generations aren't pure noise
    opt = get_optimizer("adamw", 1e-3)
    opt_state = opt.init(init_params(model))
    step_fn = make_train_step(model, cfg, opt)
    metrics = {"loss": float("nan")}
    for i in range(args.warm_steps):
        opt_state, metrics = step_fn(opt_state,
                                     make_batch_for(cfg, 8, 64, seed=i))
    warm_loss = float(metrics["loss"])
    print(f"[serve] warm-trained {cfg.arch_id} reduced to "
          f"loss={warm_loss:.3f}")

    # 1. the explorer picks the cut for a two-platform embedded system
    graph = model.to_graph(args.prompt_len)
    system = SystemConfig(
        [Platform("A", EYERISS_LIKE, QuantSpec(bits=16)),
         Platform("B", SIMBA_LIKE, QuantSpec(bits=8))],
        [get_link(args.link)])
    er = explore_graph(graph, system,
                       objectives=("latency", "energy", "throughput"),
                       search=SearchSettings(seed=0), device=dev)
    sel = er.selected.cuts if er.selected is not None else (1,)
    cuts = lm_block_cuts(sel, cfg.n_layers)
    print(f"[serve] explorer selected schedule cuts {tuple(sel)} "
          f"-> block cuts {cuts}")

    # 2. traffic + N async replicas behind the least-outstanding router
    runner = PartitionedLMRunner(model, cuts=cuts)
    reqs = poisson_traffic(args.requests, rate_rps=args.rate_rps,
                           vocab=cfg.vocab, prompt_len=args.prompt_len,
                           max_new=args.max_new, seed=123)

    def make_replicas(mode, obs=NOOP_OBS):
        reps = []
        for i in range(args.replicas):
            links = [ServeLink(model=get_link(args.link))
                     for _ in range(runner.n_stages - 1)]
            eng = PipelineServeEngine(runner, n_slots=8, n_groups=4,
                                      eos=None, mode=mode, capacity=64,
                                      links=links, name=f"replica{i}",
                                      obs=obs)
            eng.warmup(prompt_len=args.prompt_len)
            reps.append(eng)
        return reps

    # traced run: spans from every replica's stages/links plus the router
    rep_async = ReplicaRouter(make_replicas("async", obs),
                              obs=obs).serve(list(reqs), realtime=False)
    rep_serial = ReplicaRouter(make_replicas("serial")).serve(
        list(reqs), realtime=False)

    # 3. the report: throughput, Def.-4 context, per-request percentiles
    a, s = rep_async.summary(), rep_serial.summary()
    print(f"[serve] serial handoff: {s['tokens_per_s']:.0f} tok/s; "
          f"async pipeline: {a['tokens_per_s']:.0f} tok/s "
          f"(x{a['tokens_per_s'] / max(s['tokens_per_s'], 1e-9):.2f}) over "
          f"{args.replicas} replica(s), {rep_async.n_done} request(s)")
    for k in ("ttft_p50_ms", "ttft_p95_ms", "latency_p50_ms",
              "latency_p95_ms"):
        if k in a:
            print(f"[serve]   async {k} = {a[k]}")
    routed = rep_async.extra.get("routed_per_replica")
    if routed:
        print(f"[serve]   routed per replica: {routed}")
    if args.trace:
        write_chrome_trace(args.trace, obs.tracer)
        print(f"[serve] wrote Chrome trace -> {args.trace} "
              f"(python -m repro_torch.obs {args.trace})")
    if args.metrics:
        obs.metrics.write_snapshot(args.metrics)
        print(f"[serve] wrote metrics snapshot -> {args.metrics}")
    dropped = (rep_async.n_done != args.requests
               or rep_serial.n_done != args.requests)
    if dropped:
        print("[serve] ERROR: dropped requests")
    return ServeRun(model, cuts, rep_async, rep_serial, warm_loss, dropped)


def main(argv=None) -> int:
    return 1 if run(argv).dropped else 0


if __name__ == "__main__":
    raise SystemExit(main())
