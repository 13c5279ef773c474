"""Fleet launchers: N local worker processes, or the per-host commands for
a multi-host run over a shared manifest directory.

Local workers are plain subprocesses of ``python -m repro_torch.fleet worker``;
the same command is what a remote host runs (the manifest directory is the
only coordination channel, so "multi-host" just means the directory lives
on a shared filesystem).  :func:`run_fleet` is the one-call path: reclaim
stale claims, start workers, wait, merge — and because every step is
manifest-driven, running it again after a crash (or Ctrl-C) resumes instead
of recomputing.  Workers are started with ``subprocess`` (fork and exec), so
a parent that has already used CUDA starts them safely; each makes its own
CUDA context and loads the built kernels.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.explore.campaign import CampaignReport
from repro_torch.fleet.manifest import Manifest
from repro_torch.fleet.merge import merge_manifest


def _worker_env() -> Dict[str, str]:
    """Child env with ``repro`` importable even when the parent got it via
    ``sys.path`` manipulation rather than an installed package."""
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parts = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    if src not in parts:
        env["PYTHONPATH"] = os.pathsep.join([src] + parts)
    return env


def worker_command(manifest_dir: str, worker_id: Optional[str] = None,
                   verbose: bool = False, device="cuda") -> List[str]:
    cmd = [sys.executable, "-m", "repro_torch.fleet", "worker",
           "--manifest", os.path.abspath(manifest_dir),
           "--device", str(device)]
    if worker_id:
        cmd += ["--worker-id", worker_id]
    if verbose:
        cmd.append("--verbose")
    return cmd


def start_workers(manifest_dir: str, n: int, verbose: bool = False,
                  device="cuda") -> List[subprocess.Popen]:
    """Spawn ``n`` local worker processes against ``manifest_dir``, each
    searching on ``device``."""
    env = _worker_env()
    return [subprocess.Popen(worker_command(manifest_dir, verbose=verbose,
                                            device=device),
                             env=env) for _ in range(n)]


def wait_workers(procs: Sequence[subprocess.Popen]) -> List[int]:
    return [p.wait() for p in procs]


def host_commands(manifest_dir: str, hosts: Sequence[str],
                  workers_per_host: int = 1) -> str:
    """The copy-pasteable per-host commands for a multi-host run; the
    manifest directory must be on a filesystem all hosts share."""
    path = os.path.abspath(manifest_dir)
    lines = [f"# manifest: {path} (must be shared across hosts)"]
    for h in hosts:
        if workers_per_host > 1:
            cmd = (f"python -m repro_torch.fleet run --manifest {path} "
                   f"--workers {workers_per_host} --no-merge")
        else:
            cmd = f"python -m repro_torch.fleet worker --manifest {path}"
        lines.append(f"ssh {h} 'cd <repo>; PYTHONPATH=src {cmd}'")
    lines.append(f"# then, anywhere: python -m repro_torch.fleet merge "
                 f"--manifest {path} --out report.json")
    return "\n".join(lines)


def run_fleet(manifest_dir: str, workers: int = 2,
              reclaim: str = "stale", allow_failed: bool = False,
              merge: bool = True, verbose: bool = False,
              device="cuda") -> Optional[CampaignReport]:
    """Run (or resume) a sweep with ``workers`` local processes and merge.

    ``reclaim``: ``'stale'`` (default) clears claims whose owner died on
    this host — the resume-after-crash path; ``'all'`` force-clears every
    claim (only when no worker anywhere is live); ``'none'`` leaves claims
    untouched.  Done cells are never recomputed — resuming an interrupted
    manifest only runs what is still pending.  The workers search on
    ``device``; with the default ``"cuda"`` and no CUDA device it raises.
    """
    from repro_torch.explore.runner import resolve_device
    device = str(resolve_device(device))
    manifest = Manifest.load(manifest_dir)
    if reclaim not in ("stale", "all", "none"):
        raise ValueError(f"reclaim must be 'stale', 'all' or 'none', "
                         f"got {reclaim!r}")
    if reclaim != "none":
        got = manifest.reclaim_stale(force=(reclaim == "all"))
        if got and verbose:
            print(f"[fleet] reclaimed {len(got)} stale claim(s)")
    t0 = time.perf_counter()
    if not manifest.complete():
        procs = start_workers(manifest_dir, workers, verbose=verbose,
                              device=device)
        try:
            codes = wait_workers(procs)
        except KeyboardInterrupt:
            for p in procs:
                p.terminate()
            raise
        bad = [c for c in codes if c != 0]
        if bad and not manifest.complete():
            raise RuntimeError(
                f"{len(bad)} worker(s) exited non-zero and the manifest is "
                f"incomplete; inspect {manifest_dir}/failed and re-run")
    if not merge:
        return None
    report = merge_manifest(manifest, allow_failed=allow_failed)
    if verbose:
        print(f"[fleet] merged {len(report.entries)} cell(s) in "
              f"{time.perf_counter() - t0:.1f}s wall "
              f"({report.wall_s:.1f}s aggregate compute)")
    return report
