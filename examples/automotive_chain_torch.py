"""§V-C scenario on PyTorch: an automotive chain — sensor node (EYR), two
zonal gateways (EYR + SMB), central unit (SMB), all over Gigabit Ethernet.

With the batched evaluator the full k-cut space of this 4-platform chain is
small enough to enumerate, so we use the exact ``MultiCutScan`` strategy
(NSGA-II is a one-word swap in the spec: ``strategy="nsga2"``, or
``"torch_nsga2"`` for the tensor search on the device).  The Table-II
effect appears: small CNNs don't profit from 4 partitions,
EfficientNet-B0 does.

``run_spec`` takes the device of the tensor strategies: the card by
default (it raises where there is none); ``--device cpu`` runs on the CPU.

  PYTHONPATH=src python examples/automotive_chain_torch.py [--device cpu]
"""

import argparse
from collections import Counter

from repro_torch.explore import (ExplorationSpec, ModelRef, PlatformSpec,
                                 SearchSettings, SystemSpec, run_spec)

SYSTEM = SystemSpec(
    platforms=(PlatformSpec("sensor", "eyr", bits=16),
               PlatformSpec("zone-1", "eyr", bits=16),
               PlatformSpec("zone-2", "smb", bits=8),
               PlatformSpec("central", "smb", bits=8)),
    links=("gige", "gige", "gige"))
MODELS = ("squeezenet11", "efficientnet_b0")


def make_spec(name: str) -> ExplorationSpec:
    # throughput included: the §V-C discussion is throughput-driven, and
    # without it single-platform schedules dominate the 3-objective front
    return ExplorationSpec(
        model=ModelRef("cnn", name),
        system=SYSTEM,
        objectives=("latency", "energy", "bandwidth", "throughput"),
        search=SearchSettings(strategy="multicut"))


def main(device="cuda"):
    """Search each model on the chain; returns the results by model."""
    results = {}
    for name in MODELS:
        res = run_spec(make_spec(name), device=device)
        counts = Counter(e.n_partitions for e in res.pareto)
        print(f"\n{name}: pareto front of {len(res.pareto)} schedules "
              f"({res.strategy} over {len(res.candidates)} candidate "
              f"positions)")
        print("  partitions used: " +
              ", ".join(f"{k}: {counts.get(k, 0)}" for k in (1, 2, 3, 4)))
        s = res.selected
        print(f"  selected {s.cuts} -> {s.n_partitions} partitions, "
              f"lat={s.latency_s*1e3:.2f} ms, E={s.energy_j*1e3:.2f} mJ, "
              f"th={s.throughput:.0f}/s")
        results[name] = res
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the search (cpu for tests)")
    main(ap.parse_args().device)
