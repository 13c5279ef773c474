"""Drift driver — online re-partitioning through a scripted mission.

The paper's automotive/robotics scenarios have links that degrade and
nodes that drop out mid-mission.  This driver plays such a mission on a
registry LM's graph (default smollm-360m over ``eth10`` links):

  1. the explorer searches the baseline four-platform chain cold, through
     :class:`repro_torch.explore.OnlineRepartitioner` (``torch_nsga2`` on
     ``--device``, ranking through the CUDA Pareto kernels on a card);
  2. a drift schedule perturbs the system (progressive link degradation,
     then a node dropout, then the link's recovery with the node still
     down); each event triggers a *warm* re-partition — the previous front
     as the seed population, the tables of the same shape signature;
  3. each decision's cut vector is mapped to decoder-block cuts; whenever
     they change, the serving side swaps: a new
     :class:`PartitionedLMRunner` over the new cuts, fresh replicas behind
     the least-outstanding :class:`ReplicaRouter`, and (with ``--serve``)
     a burst of traffic through the re-deployed pipeline.

With ``--measured`` the loop is driven by *measurement* instead of the
scripted schedule: a :class:`~repro_torch.serve.faults.FaultPlan` degrades
a link mid-stream, a :class:`~repro_torch.serve.health.HealthMonitor`
shared with the engine estimates live link occupancy, and a
:class:`~repro_torch.serve.health.DivergenceMonitor` (hysteresis +
cool-down) fires the warm re-partition with ``trigger='measured'`` — no
explicit drift event anywhere.

The served model is the registry config's reduced variant, as in the
reference's driver, with weights drawn from a generator seeded 0 on
``--device``.

  PYTHONPATH=src python -m repro_torch.launch.drift
  PYTHONPATH=src python -m repro_torch.launch.drift --device cpu --pop 64
  PYTHONPATH=src python -m repro_torch.launch.drift --serve --requests 8
  PYTHONPATH=src python -m repro_torch.launch.drift --measured --degrade 16
"""

from __future__ import annotations

import argparse
import threading
import time

import torch

from repro_torch.core import get_link
from repro_torch.core.partition_torch import build_eval_tables
from repro_torch.explore import (ExplorationSpec, ModelRef,
                                 OnlineRepartitioner, PlatformSpec,
                                 SearchSettings, SystemSpec, degrade_link,
                                 drop_node)
from repro_torch.models.registry import ARCH_IDS, build_model, get_config
from repro_torch.obs import NOOP_OBS, Obs, write_chrome_trace
from repro_torch.utils.atomicio import atomic_write_json


def drift_schedule(base: SystemSpec):
    """The mission: link 0 degrades 4×, then 32×, then platform 1 dies,
    then the degraded link recovers with the node still down."""
    events = [degrade_link(base, 0, 4.0),
              degrade_link(base, 0, 32.0),
              drop_node(base, 1)]
    events.append(degrade_link(events[-1], 0, 1.0))  # recovered, node down
    return events


def table_signature(rp: OnlineRepartitioner, system: SystemSpec):
    """The evaluation tables' shape signature of ``system`` under ``rp``'s
    model, schedule and shared caches (built on the CPU: the signature
    holds shapes and dtypes, not the device)."""
    return build_eval_tables(rp._evaluator(system.build()),
                             "cpu").shape_signature()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.drift")
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_IDS)
    ap.add_argument("--link", default="eth10",
                    help="baseline inter-stage link "
                         "(see repro_torch.core.link)")
    ap.add_argument("--pop", type=int, default=128)
    ap.add_argument("--gens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="device the search and the served model run on "
                         "(default cuda)")
    ap.add_argument("--serve", action="store_true",
                    help="serve a traffic burst through each deployment")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8,
                    help="sequence length of the LM's layer graph and of "
                         "the served prompts")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--measured", action="store_true",
                    help="drive the re-partition from measured divergence "
                         "(injected link fault, no explicit drift event)")
    ap.add_argument("--degrade", type=float, default=8.0,
                    help="--measured: injected link slow-down factor")
    ap.add_argument("--degrade-at", type=int, default=8,
                    help="--measured: link transfer index the fault starts")
    ap.add_argument("--timeline", default="drift_timeline.json",
                    metavar="PATH",
                    help="--measured: where the drift timeline artifact "
                         "(trigger decision + measured-vs-modeled "
                         "divergence series) is written")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="--measured: also write a Chrome trace-event JSON "
                         "of the served burst")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    if cfg.family not in ("dense",):
        raise SystemExit(f"--arch {args.arch}: partitioned serving needs a "
                         "dense decoder (block-boundary stage cuts)")

    system = SystemSpec(
        platforms=(PlatformSpec("EYR0", "eyr", bits=16),
                   PlatformSpec("EYR1", "eyr", bits=16),
                   PlatformSpec("SMB0", "smb", bits=8),
                   PlatformSpec("SMB1", "smb", bits=8)),
        links=(args.link,) * 3, name="4-chain")
    spec = ExplorationSpec(
        model=ModelRef("registry", args.arch,
                       {"seq": args.prompt_len, "reduced": True}),
        system=system,
        objectives=("latency", "energy", "throughput"),
        search=SearchSettings(strategy="torch_nsga2", seed=0,
                              pop_size=args.pop, n_gen=args.gens))

    # 1. cold baseline search (the process's first use of the device)
    t0 = time.perf_counter()
    rp = OnlineRepartitioner(spec, device=args.device)
    d0 = rp.update(system)
    cold_ms = (time.perf_counter() - t0) * 1e3
    cuts = d0.block_cuts(cfg.n_layers)
    print(f"[drift] cold search on {rp.device}: {cold_ms:.0f} ms, "
          f"cuts={d0.cuts} -> blocks {cuts}")

    model = None
    if args.serve or args.measured:
        model = build_model(cfg, device=rp.device, generator=torch.Generator(
            device=rp.device).manual_seed(0))
        if args.serve:
            serve_burst(model, cuts, args, cfg, tag="baseline")

    if args.measured:
        d = measured_drift(model, cuts, args, cfg, rp, system)
        return 0 if d is not None else 1

    # 2. the drift loop: warm re-partitions, re-deploy on change
    events = drift_schedule(system)
    for d in rp.watch(events):
        new_cuts = d.block_cuts(cfg.n_layers)
        action = "keep deployment"
        if new_cuts != cuts:
            action = f"RE-DEPLOY blocks {cuts} -> {new_cuts}"
            cuts = new_cuts
        print(f"[drift] {d.label}: {d.repartition_ms:.1f} ms, "
              f"cuts={d.cuts}, feasible={d.feasible} -> {action}")
        if model is not None and action.startswith("RE-DEPLOY"):
            serve_burst(model, cuts, args, cfg, tag=d.label)

    warm = sorted(d.repartition_ms for d in rp.decisions[1:])
    sigs = {table_signature(rp, s) for s in [system] + events}
    print(f"[drift] {len(warm)} warm re-partitions, median "
          f"{warm[len(warm) // 2]:.1f} ms vs {cold_ms:.0f} ms cold; "
          f"{len(sigs)} distinct table shape signature(s) over "
          f"{len(events) + 1} systems")
    return 0


def measured_drift(model, cuts, args, cfg, rp, system):
    """Serve with an injected link degradation and let *measured*
    divergence — not an explicit drift event — trigger the warm
    re-partition.  Persists the drift timeline artifact (trigger decision
    plus the measured-vs-modeled divergence series) to ``args.timeline``
    and returns the measured-trigger decision (None when the monitor never
    fired)."""
    from repro_torch.serve import (DivergenceMonitor, FaultPlan,
                                   HealthMonitor, LinkDegrade,
                                   PipelineServeEngine, ReplicaRouter,
                                   Request, ServeLink, poisson_traffic)
    from repro_torch.serving.pipeline import PartitionedLMRunner

    obs = Obs.on() if getattr(args, "trace", None) else NOOP_OBS
    runner = PartitionedLMRunner(model, cuts=cuts)
    links = [ServeLink(model=get_link(args.link))
             for _ in range(runner.n_stages - 1)]
    # monitor sized to the *deployed system's* links: serve link i maps to
    # system link i; unused system links never accumulate samples and are
    # ignored by the divergence monitor's min_samples gate
    health = HealthMonitor(runner.n_stages, len(system.links))
    plan = FaultPlan(events=(
        LinkDegrade(0, args.degrade, at_transfer=args.degrade_at),))
    eng = PipelineServeEngine(runner, n_slots=8, n_groups=4, eos=None,
                              mode="async", capacity=64, links=links,
                              faults=plan, health=health, obs=obs)
    eng.warmup(prompt_len=args.prompt_len)
    dm = DivergenceMonitor(system, enter=max(2.0, args.degrade / 2),
                           exit=1.5, min_breach=3, cooldown_s=2.0,
                           min_samples=4, obs=obs)
    rp.obs = obs

    stop = threading.Event()

    def observer():                  # live sampling while traffic flows
        while not stop.is_set():
            dm.observe(health)
            time.sleep(0.02)

    th = threading.Thread(target=observer, daemon=True)
    th.start()
    reqs = poisson_traffic(args.requests, rate_rps=500.0, vocab=cfg.vocab,
                           prompt_len=args.prompt_len, max_new=args.max_new,
                           seed=7)
    burst = [Request(r.rid, r.prompt, r.max_new, 0.0) for r in reqs]
    rep = ReplicaRouter([eng], obs=obs).serve(burst, realtime=False)
    stop.set()
    th.join(timeout=2.0)
    dm.observe(health)               # catch a fire pending at drain time

    d = None
    if dm.signals:
        sig = dm.signals[0]
        d = rp.update(dm.drifted_system(), label=f"measured~link{sig.link}",
                      trigger="measured")
        print(f"[drift] measured {sig.divergence:.1f}x divergence on link "
              f"{sig.link} (injected {args.degrade:g}x) -> warm re-partition "
              f"{d.repartition_ms:.1f} ms, trigger={d.trigger}, "
              f"changed={d.changed}; served {rep.n_done}/{len(burst)}")
    else:
        print(f"[drift] measured: no divergence fired "
              f"(link0 div {health.link_divergence(0):.2f}x)")

    timeline = drift_timeline(dm, d, args, rep)
    if getattr(args, "timeline", None):
        atomic_write_json(args.timeline, timeline)
        print(f"[drift] wrote drift timeline -> {args.timeline} "
              f"({len(timeline['divergence_series'])} observation(s))")
    if getattr(args, "trace", None):
        write_chrome_trace(args.trace, obs.tracer)
        print(f"[drift] wrote Chrome trace -> {args.trace}")
    return d


def drift_timeline(dm, decision, args, rep) -> dict:
    """The ``--measured`` run's persistent artifact: what fault was
    injected, every (t, per-link divergence) observation the monitor saw
    (measured wire wall vs the deployed spec's model), each fired signal,
    and the re-partition decision the first signal triggered."""
    t_base = dm.history[0][0] if dm.history else 0.0
    out = {
        "timeline_schema": 1,
        "injected_fault": {"kind": "link_degrade", "link": 0,
                           "factor": args.degrade,
                           "at_transfer": args.degrade_at},
        "monitor": {"enter": dm.enter, "exit": dm.exit,
                    "min_breach": dm.min_breach,
                    "cooldown_s": dm.cooldown_s,
                    "min_samples": dm.min_samples},
        "divergence_series": [
            {"t_s": round(t - t_base, 4),
             "links": [round(v, 4) for v in divs]}
            for t, divs in dm.history],
        "signals": [
            {"t_s": round(s.at_s - t_base, 4), "link": s.link,
             "divergence": round(s.divergence, 4)}
            for s in dm.signals],
        "served": {"n_done": rep.n_done, "n_requests": len(rep.records)},
        "decision": None,
    }
    if decision is not None:
        out["decision"] = {
            "label": decision.label, "trigger": decision.trigger,
            "changed": decision.changed, "feasible": decision.feasible,
            "repartition_ms": round(decision.repartition_ms, 3),
            "cuts": list(decision.cuts) if decision.cuts else None,
        }
    return out


def serve_burst(model, cuts, args, cfg, tag: str):
    """One traffic burst through replicas deployed on ``cuts``."""
    from repro_torch.serve import (PipelineServeEngine, ReplicaRouter,
                                   Request, ServeLink, poisson_traffic)
    from repro_torch.serving.pipeline import PartitionedLMRunner

    runner = PartitionedLMRunner(model, cuts=cuts)
    replicas = []
    for i in range(args.replicas):
        links = [ServeLink(model=get_link(args.link))
                 for _ in range(runner.n_stages - 1)]
        eng = PipelineServeEngine(runner, n_slots=8, n_groups=4, eos=None,
                                  mode="async", capacity=64, links=links,
                                  name=f"replica{i}")
        eng.warmup(prompt_len=args.prompt_len)
        replicas.append(eng)
    reqs = poisson_traffic(args.requests, rate_rps=500.0, vocab=cfg.vocab,
                           prompt_len=args.prompt_len, max_new=args.max_new,
                           seed=7)
    burst = [Request(r.rid, r.prompt, r.max_new, 0.0) for r in reqs]
    rep = ReplicaRouter(replicas).serve(burst, realtime=False)
    s = rep.summary()
    print(f"[drift]   serve[{tag}]: {runner.n_stages} stages, "
          f"{rep.n_done}/{args.requests} done, "
          f"{s['tokens_per_s']:.0f} tok/s")


if __name__ == "__main__":
    raise SystemExit(main())
