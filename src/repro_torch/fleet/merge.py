"""Deterministic merge of per-cell report shards into one
:class:`~repro_torch.explore.campaign.CampaignReport`.

Entry order is the manifest's cell order — model-major / system-minor,
i.e. exactly the serial :meth:`Campaign.run` iteration order — so a merged
fleet report is *report-identical* to the serial run of the same sweep up
to wall-clock fields (:func:`report_fingerprint` is the canonical
timing-stripped comparison form; the tier-1 suite and the CI fleet-smoke
job assert fingerprint equality).  The merged ``wall_s`` aggregates compute
seconds across every shard (the serial field is end-to-end wall time; with
N workers the two diverge by design).

Shards may also be merged from an explicit iterable (e.g. shard files
rsynced from several hosts): duplicate cell ids with identical payloads
dedupe silently, diverging payloads raise :class:`ReportMergeError` —
a sweep must never silently pick one of two conflicting results.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

from repro_torch.explore.campaign import CampaignReport
from repro_torch.fleet.manifest import Manifest


class ReportMergeError(RuntimeError):
    pass


def _normalize(obj: Any) -> Any:
    """JSON-normalize (tuples -> lists, dict key order irrelevant downstream)."""
    return json.loads(json.dumps(obj))


def failed_cell_entry(model: str, system: str, error: str,
                      attempts: int = 0) -> Dict[str, Any]:
    """Placeholder entry for a terminally failed cell: the real entry shape
    (an empty ``ExplorationResult.to_report()``, so the key set can never
    drift from genuine entries) plus the failure record — downstream report
    consumers need no special casing."""
    from repro_torch.explore.result import ExplorationResult
    return {"model": model, "system": system, "wall_s": 0.0,
            "failed": True, "error": error, "attempts": attempts,
            **_normalize(ExplorationResult.empty_report())}


def _strip_timing(entry: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in entry.items() if k != "wall_s"}


def report_fingerprint(report: Union[CampaignReport, Dict[str, Any]]
                       ) -> Dict[str, Any]:
    """Canonical timing-stripped form of a campaign report: two runs of the
    same sweep (serial or fleet, any worker count) must produce equal
    fingerprints."""
    d = report.to_dict() if isinstance(report, CampaignReport) else \
        _normalize(report)
    return {"template": d["template"],
            "entries": [_strip_timing(e) for e in d["entries"]]}


def merge_shards(template: Dict[str, Any],
                 cells: Iterable[Tuple[str, str, str]],
                 shards: Iterable[Tuple[str, Dict[str, Any]]],
                 failures: Optional[Dict[str, Tuple[str, int]]] = None,
                 allow_failed: bool = False) -> CampaignReport:
    """Merge ``(cell_id, entry)`` shards for ``cells`` — an ordered iterable
    of ``(cell_id, model, system)`` — into one report.

    * entries come out in ``cells`` order regardless of shard arrival order;
    * a duplicate cell id is a conflict unless the payloads are identical
      (timing-stripped) — identical duplicates dedupe silently;
    * a cell with no shard must have a ``failures`` record *and*
      ``allow_failed=True`` to merge (as a placeholder entry); otherwise
      the merge raises, because a partial merge would masquerade as a
      complete campaign report.
    """
    by_id: Dict[str, Dict[str, Any]] = {}
    for cid, entry in shards:
        entry = _normalize(entry)
        if cid in by_id:
            if _strip_timing(by_id[cid]) != _strip_timing(entry):
                raise ReportMergeError(
                    f"conflicting shards for cell {cid!r}: two workers "
                    f"published different results for the same cell")
            continue
        by_id[cid] = entry

    cells = list(cells)
    known = {cid for cid, _, _ in cells}
    for cid in by_id:
        if cid not in known:
            raise ReportMergeError(f"shard for unknown cell {cid!r} "
                                   f"(not in this sweep's cell list)")

    failures = failures or {}
    entries: List[Dict[str, Any]] = []
    wall = 0.0
    missing: List[str] = []
    for cid, model, system in cells:
        if cid in by_id:
            entries.append(by_id[cid])
            wall += float(by_id[cid].get("wall_s", 0.0))
        elif cid in failures and allow_failed:
            err, attempts = failures[cid]
            entries.append(failed_cell_entry(model, system, err, attempts))
        else:
            missing.append(cid)
    if missing:
        raise ReportMergeError(
            f"{len(missing)} cell(s) without a shard: "
            f"{missing[:5]}{'...' if len(missing) > 5 else ''} — finish the "
            f"sweep (`python -m repro_torch.fleet run`) or pass allow_failed=True "
            f"to merge terminally failed cells as placeholders")
    return CampaignReport(template=_normalize(template), entries=entries,
                          wall_s=round(wall, 4))


def merge_manifest(manifest: Union[Manifest, str],
                   allow_failed: bool = False) -> CampaignReport:
    """Merge a manifest directory's shards (the normal path)."""
    if isinstance(manifest, str):
        manifest = Manifest.load(manifest)
    shards = []
    failures: Dict[str, Tuple[str, int]] = {}
    for c in manifest.cells:
        state = manifest.cell_state(c.id)
        if state == "done":
            shards.append((c.id, manifest.read_shard(c.id)))
        elif state == "failed":
            recs = manifest.failure_records(c.id)
            err = recs[-1]["error"] if recs else "unknown failure"
            failures[c.id] = (err, len(recs))
    return merge_shards(manifest.meta["sweep"]["template"],
                        [(c.id, c.model, c.system) for c in manifest.cells],
                        shards, failures=failures, allow_failed=allow_failed)
