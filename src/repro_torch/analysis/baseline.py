"""Baseline suppression file for the analyzer.

A baseline entry acknowledges one finding — keyed ``(rule, file,
context)``, deliberately without line numbers so unrelated edits to the
same file do not invalidate it — and MUST carry a non-empty ``reason``.
An empty reason is a configuration error (exit 2): the whole point of
the file is that every suppression is a written-down justification a
reviewer can challenge.

Format (``.analysis-baseline-torch.json`` at the repo root; the JAX
package's ``.analysis-baseline.json`` has the same schema)::

    {
      "baseline_schema": 1,
      "entries": [
        {"rule": "RPR301", "file": "src/x.py", "context": "f",
         "reason": "scratch file private to this process"}
      ]
    }

Stale entries (matching no current finding) are reported as warnings so
the file shrinks as violations get fixed, but they never fail the run.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Sequence, Set, Tuple

from repro_torch.analysis.core import Finding

BASELINE_SCHEMA = 1

Key = Tuple[str, str, str]


class BaselineError(Exception):
    """Malformed baseline file — exit code 2, not a finding."""


@dataclasses.dataclass
class Baseline:
    entries: List[Dict[str, str]]
    path: str

    def keys(self) -> Set[Key]:
        return {(e["rule"], e["file"], e["context"]) for e in self.entries}

    def reason_for(self, key: Key) -> str:
        for e in self.entries:
            if (e["rule"], e["file"], e["context"]) == key:
                return e["reason"]
        return ""


def load_baseline(path: str) -> Baseline:
    try:
        with open(path) as f:
            raw = json.load(f)
    except OSError as e:
        raise BaselineError(f"cannot read baseline {path}: {e}")
    except json.JSONDecodeError as e:
        raise BaselineError(f"baseline {path} is not valid JSON: {e}")
    if not isinstance(raw, dict) \
            or raw.get("baseline_schema") != BASELINE_SCHEMA:
        raise BaselineError(
            f"baseline {path}: expected baseline_schema="
            f"{BASELINE_SCHEMA}, got {raw.get('baseline_schema')!r}")
    entries = raw.get("entries")
    if not isinstance(entries, list):
        raise BaselineError(f"baseline {path}: 'entries' must be a list")
    for i, e in enumerate(entries):
        if not isinstance(e, dict):
            raise BaselineError(f"baseline {path}: entry {i} is not an "
                                "object")
        for field in ("rule", "file", "context", "reason"):
            if not isinstance(e.get(field), str):
                raise BaselineError(
                    f"baseline {path}: entry {i} missing string field "
                    f"{field!r}")
        if not e["reason"].strip():
            raise BaselineError(
                f"baseline {path}: entry {i} ({e['rule']} {e['file']} "
                f"[{e['context']}]) has an empty reason — every "
                "suppression needs a written justification")
    return Baseline(entries=entries, path=path)


def apply_baseline(findings: Sequence[Finding], baseline: Baseline
                   ) -> Tuple[List[Finding], List[Finding], List[Key]]:
    """Split findings into (kept, suppressed); third element lists stale
    baseline keys that matched nothing."""
    keys = baseline.keys()
    kept = [f for f in findings if f.key() not in keys]
    suppressed = [f for f in findings if f.key() in keys]
    live = {f.key() for f in findings}
    stale = sorted(k for k in keys if k not in live)
    return kept, suppressed, stale


def write_baseline(path: str, findings: Sequence[Finding],
                   reason: str = "TODO: justify this suppression") -> int:
    """Snapshot current findings into a baseline skeleton.  Reasons are
    seeded with a TODO the loader will accept (non-empty) but reviewers
    should replace; one entry per unique key."""
    seen: Set[Key] = set()
    entries = []
    for f in findings:
        if f.key() in seen:
            continue
        seen.add(f.key())
        entries.append({"rule": f.rule, "file": f.file,
                        "context": f.context, "reason": reason})
    payload = {"baseline_schema": BASELINE_SCHEMA, "entries": entries}
    from repro_torch.utils.atomicio import atomic_write_json
    atomic_write_json(path, payload)
    return len(entries)
