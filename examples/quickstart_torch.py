"""Quickstart on PyTorch: declarative exploration with ``repro_torch.explore``.

One :class:`ExplorationSpec` describes the whole run — model, system,
objectives, constraints, search strategy — and is JSON-round-trippable, so
the same spec that runs here can be stored in a config repo or shipped to a
fleet runner.  The setup is the paper's §V-A: SqueezeNet on a 16-bit
Eyeriss-like sensor node + 8-bit Simba-like central unit over GigE.

Every step that runs tensors runs on ``--device``: the card by default (it
raises where there is none), ``cpu`` on the CPU.  The tensor search of
steps 4-5 ranks its populations through the hand-written Pareto kernel
``kernels/csrc/pareto_rank.cu`` on the card; the script prints the kernels'
launch counts after each of those steps.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import torch

from repro_torch.core import Platform, QuantSpec, SystemConfig, get_link
from repro_torch.core.hwmodel import EYERISS_LIKE, SIMBA_LIKE
from repro_torch.core.partition import Constraints
from repro_torch.explore import (Campaign, ExplorationSpec, ModelRef,
                                 PlatformSpec, SearchSettings, SystemSpec,
                                 explore_graph, lm_block_cuts, run_spec)
from repro_torch.explore.runner import resolve_device
from repro_torch.fleet import report_fingerprint, run_fleet
from repro_torch.kernels import pareto_rank
from repro_torch.models.registry import build_model, get_config
from repro_torch.serve import (PipelineServeEngine, ReplicaRouter, ServeLink,
                               poisson_traffic)
from repro_torch.serving import PartitionedLMRunner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's analyzer gate, as its CI runs it
ANALYZER_ARGS = ("src/repro_torch", "chip_smoke.py", "chip_profile.py",
                 "--baseline", ".analysis-baseline-torch.json")


def make_spec() -> ExplorationSpec:
    # 1. the whole exploration as one declarative, serializable spec
    spec = ExplorationSpec(
        model=ModelRef("cnn", "squeezenet11"),
        system=SystemSpec(
            platforms=(PlatformSpec("sensor-node", "eyr", bits=16),
                       PlatformSpec("central-unit", "smb", bits=8)),
            links=("gige",)),
        objectives=("latency", "energy", "throughput"),
        constraints=Constraints(max_link_bytes=2_000_000))
    print("spec:", spec.to_json())
    assert ExplorationSpec.from_json(spec.to_json()) == spec  # round-trip
    return spec


def search(spec, device):
    # 2. run it: schedule -> candidate filtering -> metric evaluation ->
    #    search strategy -> Pareto front -> Def.-2 selection (Fig. 1)
    result = run_spec(spec, device=device)
    print(result.summary())
    print("\nPareto front:")
    for ev in sorted(result.pareto, key=lambda e: e.latency_s):
        name = (result.layer_name(ev.cuts[0]) if ev.cuts[0] >= 0
                else "all-on-central-unit")
        print(f"  cut after {name:24s} lat={ev.latency_s*1e3:7.3f} ms  "
              f"E={ev.energy_j*1e3:7.3f} mJ  th={ev.throughput:8.1f}/s")
    return result


def campaign(spec, device):
    # 3. fleet mode: fan the same spec template across the CNN zoo in one
    #    Campaign (shared per-arch cost tables) and get a serializable
    #    report
    fleet = Campaign(spec, models=[ModelRef("cnn", n)
                                   for n in ("squeezenet11", "resnet50",
                                             "efficientnet_b0")])
    report = fleet.run(device=device).report
    print("\n" + report.summary())
    return fleet, report


def kernel_launches():
    """The launch counts of the two search kernels' wrappers (K1
    ``packed_domination``, K2 ``domination_counts``); each counts only
    its CUDA launches, so both stay 0 on the CPU."""
    return {"packed_domination": pareto_rank.packed_domination.launches,
            "domination_counts": pareto_rank.domination_counts.launches}


def counted_search(spec, device, step):
    """``run_spec`` with the search kernels' counts set to 0 just before
    and printed just after."""
    pareto_rank.packed_domination.launches = 0
    pareto_rank.domination_counts.launches = 0
    result = run_spec(spec, device=device)
    print(f"step {step} kernel launches: {json.dumps(kernel_launches())}")
    return result


def tensor_search(spec, device, pop_size=4096, n_gen=40):
    # 4. big populations: strategy="torch_nsga2" runs the whole NSGA-II
    #    generation loop (ranking, crowding, variation, metric evaluation
    #    over the precomputed cost tables) as tensor code on the device —
    #    pick it when pop_size climbs into the thousands.  The ranking
    #    builds its packed domination words tile by tile in the Pareto
    #    kernel (K1), and the final population's front comes from the
    #    dominator-count kernel (K2).
    tspec = dataclasses.replace(
        spec, search=SearchSettings(strategy="torch_nsga2",
                                    pop_size=pop_size, n_gen=n_gen))
    result = counted_search(tspec, device, 4)
    print("\ntorch_nsga2:", result.summary())
    return result


def scale_spec(pop_size=2048, n_gen=12) -> ExplorationSpec:
    # 5. scaling the tensor search to very large populations — the knobs
    #    (worked example: EfficientNet-B0 across a 4-node chain, 3 cuts)
    #
    #    * rank_impl    — 'auto' (the CUDA kernels on a card, their plain
    #      PyTorch versions on the CPU), 'ref', or 'cuda' to pin a branch.
    #    * n_restarts   — >1 runs that many independently seeded searches
    #      (seeds seed..seed+n-1) and merges their fronts.
    #    * rank_devices — the ranking runs on the one search device; a
    #      value > 1 is clamped to 1 with a warning.
    return ExplorationSpec(
        model=ModelRef("cnn", "efficientnet_b0", {"in_hw": 64}),
        system=SystemSpec(
            platforms=(PlatformSpec("cam0", "eyr", bits=16),
                       PlatformSpec("cam1", "eyr", bits=16),
                       PlatformSpec("edge", "smb", bits=8),
                       PlatformSpec("central", "smb", bits=8)),
            links=("gige", "gige", "gige")),
        objectives=("latency", "energy"),
        search=SearchSettings(strategy="torch_nsga2", pop_size=pop_size,
                              n_gen=n_gen,
                              rank_impl="auto",
                              n_restarts=2))       # 2 seeds, merged


def scaled_search(device, pop_size=2048, n_gen=12):
    result = counted_search(scale_spec(pop_size, n_gen), device, 5)
    print("\ntorch_nsga2 scaled:", result.summary())
    return result


def fleet_sweep(fleet, report, device, workers=2):
    # 6. fleet mode at zoo scale: the same Campaign, distributed.  A sweep
    #    materializes as a durable work manifest (one JSON cell per
    #    model x system, states driven by atomic claim/shard files), any
    #    number of worker processes -- on this host or on many hosts
    #    sharing the directory -- claim cells and publish report shards,
    #    and the merge is report-identical to the serial Campaign.run
    #    above (same seeds, same entries, serial entry order).  The
    #    workers search on the same device.  Equivalent shell workflow:
    #
    #      python -m repro_torch.fleet init --spec spec.json \
    #          --manifest sweep.manifest
    #      python -m repro_torch.fleet run --manifest sweep.manifest \
    #          --workers 2 --device cuda
    #
    #    Kill a worker mid-cell (or the whole host) and re-run the SAME
    #    command: done cells are never recomputed, the dead worker's claim
    #    is reclaimed, and only pending work executes.
    #    `python -m repro_torch.fleet status --manifest ...` shows per-cell
    #    state; `... hosts --hosts a,b,c` prints the per-host commands.
    with tempfile.TemporaryDirectory() as mdir:
        fleet.to_manifest(mdir)                 # the Campaign from step 3
        fleet_report = run_fleet(mdir, workers=workers, verbose=True,
                                 device=device)
    print(f"\nfleet sweep ({workers} workers):")
    print(fleet_report.summary())
    assert report_fingerprint(fleet_report) == report_fingerprint(report), \
        "fleet merge must be report-identical to the serial Campaign"
    print("fleet merged report == serial campaign report (modulo "
          "wall-clock)")
    return fleet_report


def analyzer_gate():
    # 7. keep it correct: the port's own static analyzer (stdlib ast, no
    #    torch).  RPT1xx capture safety (no Python branches or host syncs
    #    on tensors inside torch.compile / CUDA-graph regions), RPT2xx the
    #    CUDA launch contracts of kernels/ (launch arity, every launch
    #    checked, one launch counter a wrapper, no fallback on a card),
    #    RPR3xx fleet atomicity, RPR4xx serve-runtime rules.  Run it
    #    locally before pushing:
    #
    #      PYTHONPATH=src python -m repro_torch.analysis
    #      PYTHONPATH=src python -m repro_torch.analysis --list-rules
    #
    #    Suppressions live in .analysis-baseline-torch.json, each with its
    #    written justification.
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    gate = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *ANALYZER_ARGS],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    print("\nstatic analysis gate:")
    print(gate.stdout.strip())
    assert gate.returncode == 0, gate.stdout + gate.stderr
    return gate.returncode


def serve(device):
    # 8. serve the partition for real: repro_torch.serve.  Everything above
    #    picks cuts from *models* of latency/energy; the serving runtime
    #    executes them — continuous batching over partitioned LM stages
    #    with per-slot admission/eviction, a thread and a CUDA stream per
    #    stage and per link, overlapping emulated link wire time with
    #    compute (Def. 4: steady-state throughput ~ 1/max(stage, link)),
    #    and a least-outstanding-slots router over N replicas.  The
    #    walkthrough: pick a cut with explore_graph on the reduced LM's
    #    graph, snap it to a decoder-block boundary with lm_block_cuts,
    #    launch 2 async replicas, read the merged TTFT/throughput report.
    dev = resolve_device(device)
    lm_cfg = get_config("smollm-360m").reduced()
    lm = build_model(lm_cfg, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))

    lm_system = SystemConfig(
        [Platform("A", EYERISS_LIKE, QuantSpec(bits=16)),
         Platform("B", SIMBA_LIKE, QuantSpec(bits=8))],
        [get_link("eth10")])                   # embedded 10 Mbit/s Ethernet
    lm_result = explore_graph(lm.to_graph(8), lm_system,
                              objectives=("latency", "energy", "throughput"),
                              device=dev)
    sel = lm_result.selected.cuts if lm_result.selected is not None else (1,)
    cuts = lm_block_cuts(sel, lm_cfg.n_layers)  # schedule cut -> block cut
    print(f"\nserve: explorer cuts {tuple(sel)} -> block cuts {cuts}")

    lm_runner = PartitionedLMRunner(lm, cuts=cuts)
    replicas = []
    for i in range(2):
        eng = PipelineServeEngine(
            lm_runner, n_slots=8, n_groups=4, mode="async", capacity=32,
            links=[ServeLink(model=get_link("eth10"))
                   for _ in range(lm_runner.n_stages - 1)],
            name=f"replica{i}")
        eng.warmup(prompt_len=8)
        replicas.append(eng)

    traffic = poisson_traffic(8, rate_rps=200.0, vocab=lm_cfg.vocab,
                              prompt_len=8, max_new=6, seed=0)
    served = ReplicaRouter(replicas).serve(list(traffic), realtime=False)
    summary = served.summary()
    print(f"serve: {served.n_done} request(s), "
          f"{summary['tokens_per_s']:.0f} tok/s over 2 replicas, "
          f"TTFT p95 {summary.get('ttft_p95_ms', 0):.0f} ms, "
          f"routed {served.extra['routed_per_replica']}")
    assert served.n_done == len(traffic), "serve dropped requests"
    return served


def main(device="cuda", pop_size=4096, n_gen=40, scale_pop=2048,
         scale_gen=12):
    """The tour, steps 1-8, at the reference example's sizes by default
    (steps 4 and 5's populations and generations are arguments)."""
    spec = make_spec()
    search(spec, device)
    fleet, report = campaign(spec, device)
    tensor_search(spec, device, pop_size, n_gen)
    scaled_search(device, scale_pop, scale_gen)
    fleet_sweep(fleet, report, device)
    analyzer_gate()
    serve(device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of every step (cpu for tests)")
    main(ap.parse_args().device)
