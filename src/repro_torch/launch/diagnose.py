"""§Perf diagnostic (the JAX package's ``repro.launch.diagnose``): build
one (arch x shape) step on the ``meta`` device, print its roofline terms
against the H100's peaks and the operations with the most FLOPs and the
most write bytes (the reference prints its top collectives, which only an
SPMD partitioner inserts).

  PYTHONPATH=src python -m repro_torch.launch.diagnose --arch qwen2-72b --shape train_4k
"""

from __future__ import annotations

import argparse

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch.dryrun import OPTS, account, run_rules
from repro_torch.launch.hlo_analysis import CostCounter, top_ops
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_setup
from repro_torch.models.registry import ARCH_IDS, get_config
from repro_torch.nn import sharding as shd


def diagnose(arch: str, shape_name: str, multi_pod: bool = False, k: int = 15,
             opts: tuple = (), grad_accum: int = 1):
    """Print and return ``(counter, Roofline)`` of one pair."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    with shd.mesh_context(mesh, run_rules(mesh, shape, multi_pod, opts)):
        counter = CostCounter()
        setup = build_setup(shape.kind, cfg, shape, mesh, multi_pod,
                            grad_accum=grad_accum, counter=counter)
        memory, roof = account(setup, counter, shape, mesh)
    coll = ("not modelled" if roof.collective_s is None
            else f"{roof.collective_s:.3f}s")
    print(f"== {arch} × {shape_name}: compute={roof.compute_s:.3f}s "
          f"memory={roof.memory_s:.3f}s coll={coll} "
          f"({roof.dominant}-bound) useful={roof.useful_flops_ratio:.2f}")
    print(f"   args/dev: {memory['argument_bytes']/2**30:.2f} GiB, whole "
          f"step on one device: peak {memory['step_peak_bytes']/2**30:.1f} "
          f"GiB, {counter.flops:.3e} FLOP, {counter.write_bytes/2**30:.1f} "
          f"GiB written")
    for by, unit, scale in (("flops", "TFLOP", 1e12),
                            ("write_bytes", "GiB", 2 ** 30)):
        print(f"   top ops by {by} (whole step | calls | op):")
        for value, op, calls in top_ops(counter, k, by):
            print(f"     {value / scale:10.3f} {unit:5s} {calls:7d}  {op}")
    return counter, roof


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES), required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--opt", action="append", default=[], choices=OPTS)
    ap.add_argument("--accum", type=int, default=1)
    args = ap.parse_args()
    diagnose(args.arch, args.shape, args.multi_pod, args.top,
             opts=tuple(args.opt), grad_accum=args.accum)
