"""The paper's technique at pod scale, on PyTorch: choose the pipeline
stage boundary for qwen3-14b across 2 and 4 modelled pods connected by
inter-pod DCI, using a single :class:`Campaign` that fans one spec template
across both system sizes (per-model cost tables are built once and shared).

The pods are the ``tpu_v5e`` entry of the port's hardware catalog
(``repro_torch/core/hwmodel/arch.py``): a cost model of a platform, the
same as the reference example's, not the device this example runs on.
The latencies it prints are that model's estimates, relative costs being
what decides the cut; nothing here is measured on any accelerator.  The
search runs on ``--device``: the card by default (it raises where there
is none), ``cpu`` on the CPU.

  PYTHONPATH=src python examples/partition_llm_pods_torch.py [--device cpu]
"""

import argparse

from repro_torch.explore import (Campaign, ExplorationSpec, ModelRef,
                                 PlatformSpec, SystemSpec)

SEQ = 4096

# a "platform" = one modelled pod (256 chips-worth of HBM, one chip's
# roofline per token-stream for the latency model)
POD = PlatformSpec("pod", "tpu_v5e", bits=16,
                   mem_capacity=256 * 16 * 2 ** 30)
SYSTEMS = [SystemSpec(platforms=(POD,) * n, links=("dci",) * (n - 1),
                      name=f"{n}pods")
           for n in (2, 4)]


def make_spec() -> ExplorationSpec:
    return ExplorationSpec(
        model=ModelRef("registry", "qwen3-14b", {"seq": SEQ}),
        system=SYSTEMS[0],
        objectives=("latency", "throughput"))


def main(device="cuda"):
    """Run the campaign over both pod counts; returns its result."""
    spec = make_spec()
    result = Campaign(spec, systems=SYSTEMS).run(device=device)
    for entry in result.entries:
        res = entry.result
        if entry.system == SYSTEMS[0].label:
            print(f"{spec.model.name}: {len(res.schedule)} graph nodes, "
                  f"{len(res.candidates)} candidate cuts")
        s = res.selected
        names = [res.layer_name(c) for c in s.cuts]
        print(f"\n{entry.system} over dci:")
        print(f"  selected cuts: {s.cuts} ({names})")
        print(f"  modelled stage latencies: "
              f"{[f'{t*1e3:.2f}ms' for t in s.stage_latency_s]}")
        print(f"  modelled link latencies:  "
              f"{[f'{t*1e3:.2f}ms' for t in s.link_latency_s]}")
        print(f"  modelled pipelined throughput: {s.throughput:.1f} seq/s "
              f"(vs single pod {res.baselines[0].throughput:.1f})")
        # for a homogeneous stack the Def.-2 optimum is the balanced split
        # — which is what repro_torch.launch.pipeline's stack_stages
        # assumes (an even split of the blocks over the stages)

    # the serializable fleet report (per-system Pareto fronts + selections)
    print("\n" + result.report.summary())
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the search (cpu for tests)")
    main(ap.parse_args().device)
