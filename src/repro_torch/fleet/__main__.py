"""``python -m repro_torch.fleet`` — the sweep-service CLI.

  init    build a manifest from a SweepSpec (or single-spec template) JSON
  run     run/resume the sweep with N local workers, then merge
  worker  one worker loop (the per-host unit for multi-host runs)
  merge   merge shards into a CampaignReport JSON
  status  cell-state counts for a manifest
  hosts   print the per-host commands for a multi-host run

A killed run resumes with the same ``run`` command: done cells are never
recomputed, stale claims from dead local workers are reclaimed
automatically.
"""

from __future__ import annotations

import argparse
import json
import sys


def _cmd_init(args) -> int:
    from repro_torch.explore.spec import ExplorationSpec, SweepSpec
    from repro_torch.fleet.manifest import Manifest
    with open(args.sweep or args.spec) as f:
        d = json.load(f)
    if args.sweep:
        sweep = SweepSpec.from_dict(d)
    else:
        # a bare ExplorationSpec template: 1-model x 1-system sweep (extend
        # by writing a SweepSpec JSON or using Campaign.to_manifest)
        sweep = SweepSpec(template=ExplorationSpec.from_dict(d))
    m = Manifest.create(args.manifest, sweep, max_retries=args.max_retries)
    print(f"manifest {m.path}: {len(m.cells)} cell(s), "
          f"spec_hash {m.spec_hash[:12]}")
    return 0


def _cmd_run(args) -> int:
    from repro_torch.fleet.launch import run_fleet
    report = run_fleet(args.manifest, workers=args.workers,
                       reclaim=args.reclaim, allow_failed=args.allow_failed,
                       merge=not args.no_merge, verbose=not args.quiet,
                       device=args.device)
    if report is not None:
        if args.out:
            report.save(args.out)
            print(f"wrote {args.out}")
        print(report.summary())
    return 0


def _cmd_worker(args) -> int:
    from repro_torch.fleet.worker import run_worker
    # failed attempts are recorded in the manifest and retried/merged there;
    # the process itself succeeded if the loop ran to completion
    run_worker(args.manifest, worker_id=args.worker_id,
               verbose=args.verbose, lease_s=args.lease, device=args.device)
    return 0


def _cmd_merge(args) -> int:
    from repro_torch.fleet.merge import merge_manifest
    report = merge_manifest(args.manifest, allow_failed=args.allow_failed)
    report.save(args.out)
    print(f"wrote {args.out} ({len(report.entries)} entries)")
    return 0


def _cmd_status(args) -> int:
    from repro_torch.fleet.manifest import Manifest
    m = Manifest.load(args.manifest)
    st = m.status()
    print(f"{m.path}: {st['cells']} cells — "
          f"{st['done']} done, {st['running']} running, "
          f"{st['pending']} pending, {st['failed']} failed "
          f"[spec {st['spec_hash']}]")
    for c in m.cells:
        print(f"  {m.cell_state(c.id):7s} {c.id}")
    return 0


def _cmd_hosts(args) -> int:
    from repro_torch.fleet.launch import host_commands
    print(host_commands(args.manifest, args.hosts.split(","),
                        workers_per_host=args.workers))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.fleet",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("init", help="build a manifest from a sweep JSON")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--sweep", help="SweepSpec JSON path")
    g.add_argument("--spec", help="single ExplorationSpec JSON path")
    p.add_argument("--manifest", required=True)
    p.add_argument("--max-retries", type=int, default=2)
    p.set_defaults(fn=_cmd_init)

    p = sub.add_parser("run", help="run/resume the sweep locally and merge")
    p.add_argument("--manifest", required=True)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--reclaim", choices=("stale", "all", "none"),
                   default="stale")
    p.add_argument("--allow-failed", action="store_true",
                   help="merge terminally failed cells as placeholders")
    p.add_argument("--no-merge", action="store_true",
                   help="run workers only (multi-host: merge separately)")
    p.add_argument("--out", help="write the merged report JSON here")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="device the workers search on (default cuda)")
    p.set_defaults(fn=_cmd_run)

    p = sub.add_parser("worker", help="run one worker loop")
    p.add_argument("--manifest", required=True)
    p.add_argument("--worker-id", default=None)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--lease", type=float, default=30.0,
                   help="claim lease TTL seconds: the heartbeat refreshes "
                        "at lease/3, and claims idle past the TTL are "
                        "reclaimed as hung")
    p.add_argument("--device", default="cuda",
                   help="device the search runs on (default cuda)")
    p.set_defaults(fn=_cmd_worker)

    p = sub.add_parser("merge", help="merge shards into a report JSON")
    p.add_argument("--manifest", required=True)
    p.add_argument("--out", default="campaign_report.json")
    p.add_argument("--allow-failed", action="store_true")
    p.set_defaults(fn=_cmd_merge)

    p = sub.add_parser("status", help="cell-state summary")
    p.add_argument("--manifest", required=True)
    p.set_defaults(fn=_cmd_status)

    p = sub.add_parser("hosts", help="print per-host commands")
    p.add_argument("--manifest", required=True)
    p.add_argument("--hosts", required=True,
                   help="comma-separated host names")
    p.add_argument("--workers", type=int, default=1,
                   help="workers per host")
    p.set_defaults(fn=_cmd_hosts)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
