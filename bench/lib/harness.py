"""Run one cell of ``BENCHMARK.json`` once and form its result line.

The cell's file names its configuration, its entry driver and its
traffic; the driver module (``bench/drivers/<driver>.py``) has three
functions:

* ``setup(run)``: build the program's state from the seed and warm up
  every shape the cell's traffic uses (the set-up time);
* ``window(state, run)``: the measured window; returns a dict with
  ``attempted``, ``failed``, ``e2e`` (end-to-end metrics by name) and
  whatever its per-layer metrics read;
* ``check(state, run, out, control)``: after the window, free the
  program's state and compare its outputs with the plain reference;
  returns :class:`Check` records, each a number beside its limit.  With
  ``control`` the reference computed in the precision below the
  configuration's stands in the program's place, and the same comparison
  has to come out not correct.

A per-layer metric is ``bench/metrics/<name>.py`` with ``read(ctx)``,
which returns a value (or a dict with ``value`` and notes) or None when
it finds nothing to read.  A traced run of a cell that the metric lists
and in which it finds nothing is refused.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Check:
    """One number compared beside its limit; ``ok`` when within it."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    """What a driver is given: the cell, its configuration, the run's
    seed, window length and device, and the trace window."""
    name: str
    cell: dict
    config: dict
    seed: int
    seconds: float
    device: Any
    tracer: Any
    trace: bool


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(name: str, root: Path = ROOT):
    """(cell, config) of the workload ``name``, found by name."""
    w = workload(load_benchmark(root), name)
    cell = load_json(root / "bench" / "cells" / f"{name}.json")
    config = load_json(root / "bench" / "configs" / f"{w['config']}.json")
    return w, cell, config


def driver_module(name: str):
    return importlib.import_module(f"bench.drivers.{name}")


def metric_module(name: str, root: Path = ROOT):
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, name: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
    workload(bench, name)
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (so ``repro_torch`` is not ``repro``)."""
    return sorted(k for k in list(sys.modules)
                  if k.split(".")[0] in FORBIDDEN)


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


@dataclasses.dataclass
class MetricContext:
    run: Run
    out: dict
    trace: Any
    power_limit_w: Optional[float]


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             overrides: Optional[dict] = None, root: Path = ROOT,
             control: bool = False) -> dict:
    """Run the cell once; returns the result object (not yet printed).
    ``overrides`` updates the cell's and configuration's keys (tests run a
    cell at a small size on the CPU this way).  ``control``: judge the
    cell's control in the program's place (never in the benchmark's own
    runs)."""
    import torch

    from bench.lib.trace import TraceWindow

    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_benchmark(root)
    _, cell, config = cell_files(name, root)
    cell.update((overrides or {}).get("cell", {}))
    config.update((overrides or {}).get("config", {}))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    drv = driver_module(cell["driver"])
    run = Run(name, cell, config, int(seed), float(seconds), dev,
              TraceWindow(trace, dev), trace)
    state = drv.setup(run)
    run.tracer.warm()
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    out = drv.window(state, run)
    if cuda:
        torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    run.tracer.collect()
    checks = drv.check(state, run, out, control=control)
    del state
    limit_w = power_limit_w() if cuda else None

    metrics: Dict[str, dict] = {}
    if not trace:
        for m in cell_metrics(bench, name, "end_to_end"):
            value = setup_s if m["name"] == "setup_s" else \
                out["e2e"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        ctx = MetricContext(run, out, run.tracer.result, limit_w)
        for m in cell_metrics(bench, name, "per_layer"):
            got = metric_module(m["name"], root).read(ctx)
            if got is None:
                raise SystemExit(f"{m['name']} found nothing to read in "
                                 f"{name}, which it lists")
            notes = dict(got) if isinstance(got, dict) else {"value": got}
            if "peak" in notes:          # a share names the card's limit
                notes["power_limit_w"] = limit_w
            metrics[m["name"]] = {"value": notes.pop("value"),
                                  "unit": m["unit"], **notes}
    result = {
        "correct": all(c.ok for c in checks),
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    tr = run.tracer.result
    if trace and tr is not None:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    found = forbidden_modules()
    if found:
        raise SystemExit(f"JAX or the JAX package was loaded: {found}")
    return result


def print_result(result: dict) -> None:
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def prepare_environment(root: Path = ROOT) -> None:
    """Caches inside the checkout at fixed paths, the program on the
    path, and no JAX behind a library's back."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)
