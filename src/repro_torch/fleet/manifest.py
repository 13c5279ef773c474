"""Durable JSON work manifest for fleet sweeps.

A manifest is a directory (usually on a filesystem shared by every worker
host) holding the sweep description and the per-cell state machine::

    <manifest_dir>/
      manifest.json              immutable sweep: SweepSpec + cell list
      claims/<cell>.claim        running: atomic O_CREAT|O_EXCL claim marker
      shards/<cell>.json         done: the cell's report entry
      failed/<cell>.attempt<N>.json   one record per failed attempt

Cell ids are stable across runs — ``c<idx>--<model>--<system>`` in
model-major / system-minor (serial ``Campaign.run``) order — and
``manifest.json`` carries the sweep's ``spec_hash`` so a worker pointed at
a manifest built from a different sweep refuses to execute.

State is derived, never stored: a cell is *done* iff its shard exists,
*running* iff a claim exists without a shard, *failed* (terminally) iff its
attempt count reached ``max_retries + 1`` without a shard, else *pending*.
All transitions are single atomic filesystem operations (exclusive create
for claims, ``os.replace`` for shards), so concurrent workers — including
workers on different hosts — never need locks beyond the filesystem's own,
and a crashed run resumes by simply pointing new workers at the directory
(after :meth:`Manifest.reclaim_stale` clears claims whose owners died).
"""

from __future__ import annotations

import dataclasses
import errno
import json
import os
import re
import socket
import time
from typing import Any, Dict, List, Optional

from repro_torch.explore.spec import SweepSpec
from repro_torch.utils.atomicio import atomic_write_json

FLEET_SCHEMA = 1


class ManifestError(RuntimeError):
    pass


def _sanitize(label: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.+-]", "_", label)


def cell_id_for(idx: int, model: str, system: str) -> str:
    """Stable, filesystem-safe cell id; the ``c<idx>`` prefix keeps ids
    unique even when model/system labels collide and preserves the serial
    iteration order under a lexical sort."""
    return f"c{idx:04d}--{_sanitize(model)}--{_sanitize(system)}"


@dataclasses.dataclass(frozen=True)
class CellInfo:
    """One (model, system) cell of the sweep fan-out."""

    id: str
    index: int          # position in serial Campaign.run order
    model_idx: int      # index into sweep.models
    system_idx: int     # index into sweep.systems
    model: str          # labels, for reports and humans
    system: str

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CellInfo":
        return cls(id=d["id"], index=int(d["index"]),
                   model_idx=int(d["model_idx"]),
                   system_idx=int(d["system_idx"]),
                   model=d["model"], system=d["system"])


def _writer_uniq() -> str:
    """Per-process unique suffix for tmp/record file names.  pid alone is
    not enough on a manifest directory shared across hosts (two hosts can
    run the same pid); the sanitized hostname disambiguates."""
    return f"{_sanitize(socket.gethostname())}-{os.getpid()}"


# manifest/shard/failure records publish through the shared write-temp-
# then-replace helper (repro_torch.utils.atomicio); claims are the one artifact
# with a different discipline (content-first O_EXCL link, see claim())
_write_atomic = atomic_write_json


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except OSError as e:
        return e.errno == errno.EPERM   # exists but not ours
    return True


class Manifest:
    """Handle on a manifest directory; see the module docstring for layout
    and state semantics."""

    def __init__(self, path: str, meta: Dict[str, Any]):
        self.path = os.path.abspath(path)
        self.meta = meta
        self.cells: List[CellInfo] = [CellInfo.from_dict(c)
                                      for c in meta["cells"]]
        self._sweep: Optional[SweepSpec] = None

    # -- creation / loading --------------------------------------------------
    @classmethod
    def create(cls, path: str, sweep: SweepSpec,
               max_retries: int = 2) -> "Manifest":
        """Create (or idempotently reopen) a manifest for ``sweep``.

        Reopening an existing directory succeeds only when its
        ``spec_hash`` matches — resuming a crashed run is the common case —
        and raises :class:`ManifestError` otherwise, so two different
        sweeps can never interleave shards in one directory.
        """
        spec_hash = sweep.spec_hash()
        mpath = os.path.join(path, "manifest.json")
        if os.path.exists(mpath):
            m = cls.load(path)
            if m.spec_hash != spec_hash:
                raise ManifestError(
                    f"manifest {path} already exists for a different sweep "
                    f"(spec_hash {m.spec_hash[:12]} != {spec_hash[:12]}); "
                    f"use a fresh directory")
            return m
        cells = [CellInfo(id=cell_id_for(i, ml, sl), index=i,
                          model_idx=mi, system_idx=si, model=ml, system=sl)
                 for i, (mi, ml, si, sl) in enumerate(
                     (mi, m.label, si, s.label)
                     for mi, m in enumerate(sweep.models)
                     for si, s in enumerate(sweep.systems))]
        meta = {
            "fleet_schema": FLEET_SCHEMA,
            "spec_hash": spec_hash,
            "max_retries": int(max_retries),
            "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "sweep": sweep.to_dict(),
            "cells": [c.to_dict() for c in cells],
        }
        os.makedirs(path, exist_ok=True)
        for sub in ("claims", "shards", "failed"):
            os.makedirs(os.path.join(path, sub), exist_ok=True)
        _write_atomic(mpath, meta)
        return cls(path, meta)

    @classmethod
    def load(cls, path: str) -> "Manifest":
        mpath = os.path.join(path, "manifest.json")
        try:
            with open(mpath) as f:
                meta = json.load(f)
        except FileNotFoundError:
            raise ManifestError(f"no manifest.json in {path}; create one "
                                f"with Campaign.to_manifest() or "
                                f"`python -m repro_torch.fleet init`")
        except (OSError, json.JSONDecodeError) as e:
            raise ManifestError(f"unreadable manifest {mpath}: {e}")
        if meta.get("fleet_schema") != FLEET_SCHEMA:
            raise ManifestError(
                f"manifest {path} has fleet_schema="
                f"{meta.get('fleet_schema')!r}, this code speaks "
                f"{FLEET_SCHEMA}")
        for sub in ("claims", "shards", "failed"):
            os.makedirs(os.path.join(path, sub), exist_ok=True)
        return cls(path, meta)

    # -- basic accessors -----------------------------------------------------
    @property
    def spec_hash(self) -> str:
        return self.meta["spec_hash"]

    @property
    def max_retries(self) -> int:
        return int(self.meta.get("max_retries", 2))

    @property
    def sweep(self) -> SweepSpec:
        if self._sweep is None:
            self._sweep = SweepSpec.from_dict(self.meta["sweep"])
        return self._sweep

    def _claim_path(self, cell_id: str) -> str:
        return os.path.join(self.path, "claims", f"{cell_id}.claim")

    def _shard_path(self, cell_id: str) -> str:
        return os.path.join(self.path, "shards", f"{cell_id}.json")

    def _failed_path(self, cell_id: str, attempt: int) -> str:
        # writer suffix: two workers racing to record the same attempt
        # number (possible only through reclaim races) append two records
        # instead of silently overwriting one
        return os.path.join(
            self.path, "failed",
            f"{cell_id}.attempt{attempt}-{_writer_uniq()}.json")

    # -- derived state -------------------------------------------------------
    _ATTEMPT_RE = re.compile(r"^(?P<cell>.+)\.attempt\d+-[\w.+-]+\.json$")

    def _failure_counts(self) -> Dict[str, int]:
        """One ``failed/`` listing -> per-cell attempt counts (workers scan
        every cell per loop iteration; per-cell listdir would be
        O(cells × failures) metadata traffic on a shared filesystem)."""
        counts: Dict[str, int] = {}
        for n in os.listdir(os.path.join(self.path, "failed")):
            m = self._ATTEMPT_RE.match(n)
            if m:
                cell = m.group("cell")
                counts[cell] = counts.get(cell, 0) + 1
        return counts

    def attempts(self, cell_id: str) -> int:
        return self._failure_counts().get(cell_id, 0)

    def _state(self, cell_id: str, attempts: int) -> str:
        if os.path.exists(self._shard_path(cell_id)):
            return "done"
        if os.path.exists(self._claim_path(cell_id)):
            return "running"
        if attempts > self.max_retries:
            return "failed"
        return "pending"

    def cell_state(self, cell_id: str) -> str:
        return self._state(cell_id, self.attempts(cell_id))

    def cells_in_state(self, state: str) -> List[CellInfo]:
        counts = self._failure_counts()
        return [c for c in self.cells
                if self._state(c.id, counts.get(c.id, 0)) == state]

    def pending_cells(self) -> List[CellInfo]:
        return self.cells_in_state("pending")

    def complete(self) -> bool:
        """Every cell either done or terminally failed."""
        counts = self._failure_counts()
        return all(self._state(c.id, counts.get(c.id, 0))
                   in ("done", "failed") for c in self.cells)

    def status(self) -> Dict[str, Any]:
        counts: Dict[str, int] = {"pending": 0, "running": 0, "done": 0,
                                  "failed": 0}
        fails = self._failure_counts()
        for c in self.cells:
            counts[self._state(c.id, fails.get(c.id, 0))] += 1
        return {"cells": len(self.cells), **counts,
                "spec_hash": self.spec_hash[:12]}

    # -- transitions (all single atomic fs ops) ------------------------------
    def claim(self, cell_id: str, worker_id: str) -> bool:
        """Atomically claim a cell; False when another worker holds it.

        The claim body is written to a private tmp file and ``os.link``-ed
        into place, so the claim appears *with its content* in one atomic
        step — a half-written claim can never exist for ``reclaim_stale``
        (which treats unreadable claims as crashed) to steal mid-write.
        """
        cpath = self._claim_path(cell_id)
        tmp = f"{cpath}.tmp.{_writer_uniq()}"
        with open(tmp, "w") as f:
            json.dump({"worker": worker_id, "pid": os.getpid(),
                       "host": socket.gethostname(),
                       "time": time.time()}, f)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, cpath)
            return True
        except FileExistsError:
            return False
        finally:
            os.unlink(tmp)

    def refresh_claim(self, cell_id: str) -> bool:
        """Refresh the lease on a held claim (bump its mtime).

        Workers call this periodically while executing a cell so that a
        TTL-based :meth:`reclaim_stale` (``lease_ttl_s``) can distinguish
        a *hung* worker (claim held, lease never refreshed) from a slow
        but live one.  The bumped mtime also makes any in-progress
        reclaimer's identity re-check fail, so a refresh doubles as
        protection against a concurrent steal.  Returns False when the
        claim no longer exists (already released or reclaimed)."""
        try:
            os.utime(self._claim_path(cell_id))
            return True
        except FileNotFoundError:
            return False

    def release(self, cell_id: str) -> None:
        try:
            os.unlink(self._claim_path(cell_id))
        except FileNotFoundError:
            pass

    def write_shard(self, cell_id: str, entry: Dict[str, Any],
                    worker_id: str = "?") -> None:
        """Publish a finished cell (atomic) and drop its claim."""
        _write_atomic(self._shard_path(cell_id),
                      {"fleet_schema": FLEET_SCHEMA, "cell": cell_id,
                       "spec_hash": self.spec_hash, "worker": worker_id,
                       "entry": entry})
        self.release(cell_id)

    def read_shard(self, cell_id: str) -> Dict[str, Any]:
        with open(self._shard_path(cell_id)) as f:
            shard = json.load(f)
        if shard.get("spec_hash") != self.spec_hash:
            raise ManifestError(
                f"shard {cell_id} was produced by a different sweep "
                f"(spec_hash mismatch)")
        return shard["entry"]

    def record_failure(self, cell_id: str, worker_id: str,
                       error: str) -> int:
        """Record one failed attempt and free the cell for retry; returns
        the attempt count so far."""
        n = self.attempts(cell_id) + 1
        _write_atomic(self._failed_path(cell_id, n),
                      {"cell": cell_id, "worker": worker_id, "error": error,
                       "attempt": n, "time": time.time()})
        self.release(cell_id)
        return n

    def failure_records(self, cell_id: str) -> List[Dict[str, Any]]:
        fdir = os.path.join(self.path, "failed")
        prefix = f"{cell_id}.attempt"
        out = []
        for name in sorted(n for n in os.listdir(fdir)
                           if n.startswith(prefix)
                           and self._ATTEMPT_RE.match(n)):
            try:
                with open(os.path.join(fdir, name)) as f:
                    out.append(json.load(f))
            except (OSError, json.JSONDecodeError):
                pass
        out.sort(key=lambda r: (r.get("attempt", 0), r.get("time", 0)))
        return out

    # -- crash recovery ------------------------------------------------------
    # minimum claim age before reclaim may touch it: a decision made from a
    # stale read can then never hit a *freshly re-acquired* claim (new claims
    # have a new mtime), which closes the unlink-a-live-claim race between
    # concurrent reclaimers
    _RECLAIM_GRACE_S = 2.0

    def reclaim_stale(self, force: bool = False,
                      lease_ttl_s: Optional[float] = None) -> List[str]:
        """Remove claims whose owning process is provably gone or whose
        lease expired.

        A claim is stale when its recorded pid is dead *on this host*
        (claims from other hosts can't be probed, so they are only removed
        with ``force=True`` — use after confirming the remote workers are
        down), or — with ``lease_ttl_s`` — when its mtime is older than the
        TTL: live workers refresh their claim's mtime periodically
        (:meth:`refresh_claim`), so an expired lease means the worker is
        dead **or hung**, on any host.  Claims younger than a short grace
        period are never touched, and the claim file's identity
        (inode + mtime) is re-verified immediately before the unlink, so a
        claim re-acquired — or lease-refreshed — by a live worker after
        this reclaimer's read cannot be deleted by mistake.  Returns the
        reclaimed cell ids.
        """
        if lease_ttl_s is not None and lease_ttl_s <= 0:
            raise ValueError(f"lease_ttl_s must be > 0, got {lease_ttl_s}")
        host = socket.gethostname()
        reclaimed = []
        for c in self.cells:
            cpath = self._claim_path(c.id)
            if os.path.exists(self._shard_path(c.id)):
                continue
            try:
                st = os.stat(cpath)
            except FileNotFoundError:
                continue
            age = time.time() - st.st_mtime
            if age < self._RECLAIM_GRACE_S:
                continue
            stale = force or (lease_ttl_s is not None and age > lease_ttl_s)
            if not stale:
                try:
                    with open(cpath) as f:
                        claim = json.load(f)
                    stale = (claim.get("host") == host
                             and not _pid_alive(int(claim.get("pid", -1))))
                except (OSError, json.JSONDecodeError, ValueError):
                    stale = True      # unreadable claim: treat as crashed
            if not stale:
                continue
            try:                      # the claim we judged is still the one
                st2 = os.stat(cpath)  # on disk (claims are never rewritten
            except FileNotFoundError:  # in place, only created/unlinked)
                continue
            if (st2.st_ino, st2.st_mtime_ns) != (st.st_ino, st.st_mtime_ns):
                continue
            self.release(c.id)
            reclaimed.append(c.id)
        return reclaimed
