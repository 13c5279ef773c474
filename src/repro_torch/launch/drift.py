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
  3. each decision's cut vector is mapped to decoder-block cuts, and the
     driver reports whether the deployment would change.

  PYTHONPATH=src python -m repro_torch.launch.drift
  PYTHONPATH=src python -m repro_torch.launch.drift --device cpu --pop 64

The JAX package's driver also serves a traffic burst through each
deployment (``--serve``) and drives the loop from measured link divergence
(``--measured``).  Both need the serve runtime, which the port does not
have yet (ROADMAP C4 and C5a): here they raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.core.partition_torch import build_eval_tables
from repro_torch.explore import (ExplorationSpec, ModelRef,
                                 OnlineRepartitioner, PlatformSpec,
                                 SearchSettings, SystemSpec, degrade_link,
                                 drop_node)
from repro_torch.models.registry import ARCH_IDS, get_config


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
    ap.add_argument("--prompt-len", type=int, default=8,
                    help="sequence length of the LM's layer graph")
    ap.add_argument("--device", default="cuda",
                    help="device the search runs on (default cuda)")
    ap.add_argument("--serve", action="store_true",
                    help="not in the port yet (ROADMAP C4/C5a)")
    ap.add_argument("--measured", action="store_true",
                    help="not in the port yet (ROADMAP C4/C5a)")
    args = ap.parse_args(argv)
    if args.serve or args.measured:
        raise NotImplementedError(
            "--serve and --measured need the serve runtime "
            "(repro_torch.serve), which the port does not have yet: "
            "ROADMAP C4 (serve/) and C5a (the LM drivers)")

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

    warm = sorted(d.repartition_ms for d in rp.decisions[1:])
    sigs = {table_signature(rp, s) for s in [system] + events}
    print(f"[drift] {len(warm)} warm re-partitions, median "
          f"{warm[len(warm) // 2]:.1f} ms vs {cold_ms:.0f} ms cold; "
          f"{len(sigs)} distinct table shape signature(s) over "
          f"{len(events) + 1} systems")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
