"""Dry-run of every (architecture x input shape) on a pod mesh (the JAX
package's ``repro.launch.dryrun``): build each step on the ``meta``
device, count it, and print memory and roofline rows against the H100's
peaks.

Nothing is allocated and no device is needed: the step runs on meta
stand-ins under ``hlo_analysis.CostCounter``.  A row holds

* computed: the bytes of the step's arguments and outputs that one device
  of the mesh holds under the rules (``launch/rules.py``; exact), the
  step's FLOPs and write bytes (whole step, and per device split evenly
  over the mesh), the peak bytes the step holds at once on one device
  (arguments and the live bytes the counter tracked);
* null, with its reason under ``not_modelled``: what only an SPMD
  partitioner could give on a mesh of more than one device (the
  collectives each device would run, and its temporary bytes), and the
  generated code (eager PyTorch compiles no program).

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-360m --shape decode_32k
  python -m repro_torch.launch.dryrun --all                  # 10 x 4 single-pod
  python -m repro_torch.launch.dryrun --all --multi-pod      # 2-pod mesh
  python -m repro_torch.launch.dryrun --arch ... --shape ... --out rows.json
"""

from __future__ import annotations

import argparse
import time
import traceback

from repro_torch.configs.base import INPUT_SHAPES, ShapeConfig
from repro_torch.launch import rules as R
from repro_torch.launch.hlo_analysis import CostCounter
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import analyze
from repro_torch.launch.steps import Setup, build_setup
from repro_torch.models.registry import ARCH_IDS, get_config, supports_shape
from repro_torch.nn import sharding as shd
from repro_torch.nn.sharding import Mesh
from repro_torch.utils.atomicio import atomic_write_json

OPTS = ["attn_heads", "mla_latent", "fsdp", "remat_dots", "expert_ep",
        "softmax_low"]

NOT_MODELLED = {
    "collectives": "per-device collectives on a mesh of more than one "
                   "device need an SPMD partitioner; the port runs the "
                   "step on one device",
    "temp_bytes": "per-device temporaries on a mesh of more than one "
                  "device need an SPMD partitioner",
    "generated_code_bytes": "eager PyTorch compiles no program",
}


def run_rules(mesh: Mesh, shape: ShapeConfig, multi_pod: bool,
              opts: tuple = ()) -> dict:
    """The activation rules of a run of ``shape`` on ``mesh``."""
    nb = mesh.shape.get("pod", 1) * mesh.shape["data"]
    return R.activation_rules(shape.kind, multi_pod,
                              batch_divisible=shape.global_batch % nb == 0,
                              opts=tuple(opts))


def account(setup: Setup, counter: CostCounter, shape: ShapeConfig,
            mesh: Mesh):
    """``(memory, Roofline)`` of ``setup``'s step, counted by ``counter``.
    ``memory`` holds the argument and output bytes one device holds under
    the shardings, and ``step_peak_bytes``: the whole step's arguments
    and the most bytes it held at once besides, on one device."""
    whole_args = R.per_device_bytes(
        setup.arg_shapes, R.replicated(setup.arg_shapes, mesh))
    step_peak = whole_args + counter.peak_bytes
    one = mesh.size == 1
    memory = {
        "argument_bytes": R.per_device_bytes(setup.arg_shapes,
                                             setup.in_shardings),
        "output_bytes": R.per_device_bytes(setup.out_shapes,
                                           setup.out_shardings),
        "temp_bytes": counter.peak_bytes if one else None,
        "generated_code_bytes": None,
        "step_peak_bytes": step_peak,
    }
    roof = analyze(counter.costs(), setup.cfg, shape, mesh.size,
                   peak_memory_bytes=step_peak if one else None)
    return memory, roof


def dryrun_one(arch: str, shape_name: str, multi_pod: bool = False,
               verbose: bool = True, opts: tuple = (),
               grad_accum: int = 1) -> dict:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if not supports_shape(cfg, shape):
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "full-attention arch without sub-quadratic variant"}
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size
    kind = shape.kind
    t0 = time.time()
    try:
        with shd.mesh_context(mesh, run_rules(mesh, shape, multi_pod, opts)):
            counter = CostCounter()
            setup = build_setup(kind, cfg, shape, mesh, multi_pod,
                                grad_accum=grad_accum, counter=counter)
            memory, roof = account(setup, counter, shape, mesh)
        t_build = time.time() - t0
        not_modelled = dict(NOT_MODELLED)
        if n_dev == 1:
            del not_modelled["collectives"], not_modelled["temp_bytes"]
        row = {
            "arch": arch, "shape": shape_name, "kind": kind,
            "multi_pod": multi_pod, "n_devices": n_dev,
            "opts": list(opts),
            "build_s": round(t_build, 1),
            "memory": memory,
            "step_flops": counter.flops,
            "step_write_bytes": counter.write_bytes,
            "not_modelled": not_modelled,
            **roof.row(),
        }
        if verbose:
            coll = ("n/m" if roof.collective_s is None
                    else f"{roof.collective_s * 1e3:.1f}ms")
            print(f"[dryrun] {arch} × {shape_name}"
                  f"{' ×2pod' if multi_pod else ''}: "
                  f"compute={roof.compute_s*1e3:.1f}ms "
                  f"memory={roof.memory_s*1e3:.1f}ms "
                  f"coll={coll} → {roof.dominant}-bound; "
                  f"args/dev={memory['argument_bytes']/2**30:.2f}GiB "
                  f"step peak={memory['step_peak_bytes']/2**30:.2f}GiB "
                  f"useful={roof.useful_flops_ratio:.2f} "
                  f"(built and counted in {t_build:.1f}s)")
        return row
    except Exception as e:
        if verbose:
            traceback.print_exc()
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "error": f"{type(e).__name__}: {e}"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--opt", action="append", default=[], choices=OPTS,
                    help="enable a §Perf optimization (repeatable)")
    args = ap.parse_args(argv)

    rows = []
    if args.all:
        pairs = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        pairs = [(args.arch, args.shape)]
    for arch, shape in pairs:
        rows.append(dryrun_one(arch, shape, args.multi_pod,
                               opts=tuple(args.opt)))
    if args.out:
        atomic_write_json(args.out, rows)
        print(f"wrote {len(rows)} rows to {args.out}")
    n_err = sum(1 for r in rows if "error" in r)
    n_skip = sum(1 for r in rows if r.get("skipped"))
    print(f"dry-run: {len(rows) - n_err - n_skip} ok, {n_skip} skipped, "
          f"{n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
