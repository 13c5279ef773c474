"""Fleet worker: claim cells from a manifest, run the search, publish
shards.

One worker is one process (``python -m repro_torch.fleet worker``); any number of
them may point at the same manifest directory, on one host or many.  The
loop is coordinator-free:

1. list pending cells in serial-run order, try to claim each (atomic
   exclusive create) until one sticks;
2. run the cell through the exact serial-campaign code path
   (:func:`repro_torch.explore.runner.explore_graph` with the template's
   objectives/constraints/strategy — including ``torch_nsga2`` on the
   worker's ``device``), reusing
   per-model graph/schedule/Def.-3-memory caches and the per-arch
   ``cost_cache`` across every cell of the same model this worker executes,
   so cost tables are built once per (worker, model) like the serial
   ``Campaign`` builds them once per model;
3. publish the report entry as an atomic shard and release the claim; on
   an exception, record the failed attempt and release — the cell returns
   to pending until the manifest's bounded retry budget is spent.

A worker exits when the manifest is complete (all cells done or terminally
failed).  While cells are claimed by *other* workers it polls, reclaiming
claims whose owner died on this host, so killing a worker mid-cell never
wedges the sweep.
"""

from __future__ import annotations

import os
import socket
import threading
import time
import traceback
from typing import Any, Dict, Optional

from repro_torch.fleet.manifest import CellInfo, Manifest
from repro_torch.obs.metrics import default_registry


def default_worker_id() -> str:
    return f"{socket.gethostname()}-{os.getpid()}"


class _ModelCache:
    """Per-worker shared state for one model: built graph, schedule, memory
    table and the per-arch cost-table cache (shared across systems, exactly
    like the serial Campaign loop)."""

    def __init__(self, sweep, model_idx: int):
        from repro_torch.core.graph import linearize
        from repro_torch.core.memory import SegmentMemoryTable
        mref = sweep.models[model_idx]
        self.graph, self.shared = mref.build()
        self.schedule = linearize(self.graph, sweep.template.schedule_policy)
        self.memtable = SegmentMemoryTable(self.schedule, self.shared)
        self.cost_cache: Dict = {}


def run_cell(manifest: Manifest, cell: CellInfo,
             model_caches: Optional[Dict[int, _ModelCache]] = None,
             device="cuda") -> Dict[str, Any]:
    """Execute one claimed cell, with the tensor strategies on ``device``;
    returns its report entry dict."""
    from repro_torch.explore.campaign import campaign_entry_dict
    from repro_torch.explore.runner import explore_graph
    sweep = manifest.sweep
    tpl = sweep.template
    caches = model_caches if model_caches is not None else {}
    mc = caches.get(cell.model_idx)
    if mc is None:
        mc = caches[cell.model_idx] = _ModelCache(sweep, cell.model_idx)
    system = sweep.systems[cell.system_idx].build()
    t0 = time.perf_counter()
    res = explore_graph(
        mc.graph, system, objectives=tpl.objectives, weights=tpl.weights,
        constraints=tpl.constraints, search=tpl.search, batch=tpl.batch,
        accuracy=tpl.accuracy, shared_groups=mc.shared,
        schedule=mc.schedule, cost_cache=mc.cost_cache,
        memtable=mc.memtable, device=device)
    wall = time.perf_counter() - t0
    return campaign_entry_dict(cell.model, cell.system, res, wall)


def _lease_heartbeat(manifest: Manifest, cell_id: str, lease_s: float,
                     stop: threading.Event) -> None:
    """Refresh the claim's lease every ``lease_s / 3`` until stopped (or
    until the claim disappears — released or reclaimed from under us)."""
    period = max(lease_s / 3.0, 0.05)
    hist = default_registry().histogram("fleet_heartbeat_refresh_s")
    while not stop.wait(period):
        t0 = time.perf_counter()
        ok = manifest.refresh_claim(cell_id)
        hist.observe(time.perf_counter() - t0)
        if not ok:
            return


def run_worker(manifest_dir: str, worker_id: Optional[str] = None,
               poll_s: float = 0.5, verbose: bool = False,
               lease_s: float = 30.0, device="cuda") -> Dict[str, int]:
    """The worker loop; returns ``{"done": n, "failed": n}`` attempt counts
    for this worker's own work.  Every cell's tensor strategies run on
    ``device``; with the default ``"cuda"`` and no CUDA device it raises.

    While a cell runs, a heartbeat thread refreshes the claim's lease
    every ``lease_s / 3``, and the idle-poll reclaim passes
    ``lease_ttl_s=lease_s`` — so a *hung* worker (process alive, cell
    stuck, lease never refreshed) expires after the TTL just like a dead
    one, on any host."""
    from repro_torch.explore.runner import resolve_device
    if lease_s <= 0:
        raise ValueError(f"lease_s must be > 0, got {lease_s}")
    device = str(resolve_device(device))
    manifest = Manifest.load(manifest_dir)
    wid = worker_id or default_worker_id()
    stats = {"done": 0, "failed": 0}
    caches: Dict[int, _ModelCache] = {}
    reg = default_registry()

    def say(msg: str) -> None:
        if verbose:
            print(f"[fleet:{wid}] {msg}", flush=True)

    while True:
        claimed = None
        for cell in manifest.pending_cells():
            if manifest.claim(cell.id, wid):
                claimed = cell
                break
        if claimed is None:
            if manifest.complete():
                say(f"manifest complete; exiting "
                    f"(done={stats['done']} failed={stats['failed']})")
                return stats
            # other workers hold the remaining cells: recover any whose
            # owner died on this host or whose lease expired (hung worker
            # on any host), then wait for live ones
            reclaimed = manifest.reclaim_stale(lease_ttl_s=lease_s)
            if reclaimed:
                reg.counter("fleet_cells_reclaimed").inc(len(reclaimed))
                continue
            time.sleep(poll_s)
            continue
        say(f"claimed {claimed.id}")
        reg.counter("fleet_cells_claimed").inc()
        stop_hb = threading.Event()
        hb = threading.Thread(target=_lease_heartbeat,
                              args=(manifest, claimed.id, lease_s, stop_hb),
                              name=f"lease-{claimed.id}", daemon=True)
        hb.start()
        try:
            entry = run_cell(manifest, claimed, caches, device=device)
        except KeyboardInterrupt:
            stop_hb.set()
            hb.join(timeout=5.0)
            manifest.release(claimed.id)
            raise
        except Exception:
            stop_hb.set()
            hb.join(timeout=5.0)
            n = manifest.record_failure(claimed.id, wid,
                                        traceback.format_exc())
            stats["failed"] += 1
            reg.counter("fleet_cells_failed").inc()
            say(f"FAILED {claimed.id} (attempt {n}/"
                f"{manifest.max_retries + 1})")
            continue
        stop_hb.set()
        hb.join(timeout=5.0)
        manifest.write_shard(claimed.id, entry, wid)
        stats["done"] += 1
        reg.counter("fleet_cells_done").inc()
        reg.histogram("fleet_cell_wall_s").observe(entry["wall_s"])
        say(f"done {claimed.id} ({entry['wall_s']:.2f}s)")
