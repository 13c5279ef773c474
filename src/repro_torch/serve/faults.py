"""Deterministic fault injection for the serve runtime.

The paper's deployment environments (automotive buses, robot meshes) fail
in specific, recurring ways: links degrade, nodes stall, replicas die
mid-stream.  Testing the runtime's reaction to those failures is only
useful when every failure is **reproducible** — a crash that lands on a
different decode step each run cannot anchor a byte-identity assertion.

A :class:`FaultPlan` is a declarative schedule of fault events keyed on
*resource-local logical indices*, never on wall-clock time:

* :class:`LinkDegrade` applies from the link's Nth transfer (each link
  shuttle counts its own transfers — single-threaded per link, so the
  index is exact);
* :class:`StageStall` injects a one-shot host sleep before the stage's
  Nth work item (per-stage item counter, same argument);
* :class:`ReplicaCrash` raises :class:`ReplicaCrashError` in the driver
  after the Kth completed decode step (the driver is single-threaded, so
  the step count is exact);
* ``link_jitter_s`` adds seeded per-transfer jitter to every link sleep —
  drawn from ``SeedSequence((seed, link, transfer))``, so the same plan
  produces the same jitter trace on every run.

The engine records every *applied* fault in a :class:`FaultTrace` whose
:meth:`~FaultTrace.canonical` form is independent of thread interleaving
(entries are bucketed per resource and each resource's counter is owned by
exactly one thread).  ``tests/test_torch_serve_faults.py`` asserts that
two runs of the same plan produce identical canonical traces.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class LinkDegrade:
    """Slow link ``link`` down by ``factor`` from its ``at_transfer``-th
    transfer (0-based, counted per link) until ``until_transfer``
    (exclusive; ``None`` = permanent).  The emulated wire sleep is
    multiplied by ``factor``, exactly what a real rate drop does to the
    occupancy the health monitor measures."""

    link: int
    factor: float
    at_transfer: int = 0
    until_transfer: Optional[int] = None

    def __post_init__(self):
        if self.factor <= 0:
            raise ValueError(f"factor must be > 0, got {self.factor}")
        if self.link < 0 or self.at_transfer < 0:
            raise ValueError("link and at_transfer must be >= 0")


@dataclasses.dataclass(frozen=True)
class StageStall:
    """Stall stage ``stage`` for ``stall_s`` host seconds immediately
    before it processes its ``at_item``-th work item (0-based, counted
    per stage) — the hung-node scenario the failure detector must catch
    via missed heartbeats."""

    stage: int
    stall_s: float
    at_item: int = 0

    def __post_init__(self):
        if self.stall_s < 0:
            raise ValueError(f"stall_s must be >= 0, got {self.stall_s}")
        if self.stage < 0 or self.at_item < 0:
            raise ValueError("stage and at_item must be >= 0")


@dataclasses.dataclass(frozen=True)
class ReplicaCrash:
    """Kill the replica (raise :class:`ReplicaCrashError` in its driver
    loop) after ``at_step`` completed decode steps.  In-flight and queued
    requests are stranded — recovering them is the router's job."""

    at_step: int

    def __post_init__(self):
        if self.at_step < 0:
            raise ValueError(f"at_step must be >= 0, got {self.at_step}")


FaultEvent = Union[LinkDegrade, StageStall, ReplicaCrash]


class ReplicaCrashError(RuntimeError):
    """An injected replica crash (see :class:`ReplicaCrash`); carries the
    decode step at which the replica died."""

    def __init__(self, name: str, step: int):
        super().__init__(f"injected crash of {name} at decode step {step}")
        self.replica = name
        self.step = step


class FaultTrace:
    """Applied-fault log with a thread-interleaving-independent canonical
    form.  Entries are appended under a lock by whichever worker applied
    the fault; :meth:`canonical` buckets them per resource and sorts each
    bucket by the resource-local index, which is deterministic because
    each resource counter is owned by exactly one thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: List[Tuple] = []

    def record(self, kind: str, resource: int, index: int, *detail) -> None:
        """Append one applied-fault entry (thread-safe)."""
        with self._lock:
            self._entries.append((kind, resource, index) + detail)

    @property
    def entries(self) -> List[Tuple]:
        """Raw entries in append order (thread-interleaving dependent)."""
        with self._lock:
            return list(self._entries)

    def canonical(self) -> List[Tuple]:
        """Entries sorted by (kind, resource, index[, detail]) — the form
        two runs of the same plan must agree on byte-for-byte."""
        with self._lock:
            return sorted(self._entries)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


@dataclasses.dataclass
class FaultPlan:
    """A deterministic schedule of injected faults for one serve run.

    ``events`` is any mix of :class:`LinkDegrade`, :class:`StageStall`
    and :class:`ReplicaCrash`; ``link_jitter_s`` > 0 additionally perturbs
    every link sleep by a seeded uniform draw in ``[0, link_jitter_s)``.
    All lookups are pure functions of (resource, local index), so the
    same plan replayed over the same traffic injects the identical fault
    sequence — the property ``tests/test_torch_serve_faults.py`` pins
    down.
    """

    events: Tuple[FaultEvent, ...] = ()
    link_jitter_s: float = 0.0
    seed: int = 0

    def __post_init__(self):
        self.events = tuple(self.events)
        if self.link_jitter_s < 0:
            raise ValueError("link_jitter_s must be >= 0")
        self._stalls: Dict[Tuple[int, int], float] = {}
        crash = None
        for ev in self.events:
            if isinstance(ev, StageStall):
                key = (ev.stage, ev.at_item)
                self._stalls[key] = self._stalls.get(key, 0.0) + ev.stall_s
            elif isinstance(ev, ReplicaCrash):
                if crash is not None:
                    raise ValueError("a FaultPlan may hold at most one "
                                     "ReplicaCrash")
                crash = ev.at_step
            elif not isinstance(ev, LinkDegrade):
                raise TypeError(f"unknown fault event {ev!r}")
        self._crash_step = crash

    # -- link faults ---------------------------------------------------------
    def link_factor(self, link: int, transfer: int) -> float:
        """Wire-time multiplier for the link's ``transfer``-th transfer
        (compounds overlapping degradations; 1.0 = healthy)."""
        factor = 1.0
        for ev in self.events:
            if (isinstance(ev, LinkDegrade) and ev.link == link
                    and ev.at_transfer <= transfer
                    and (ev.until_transfer is None
                         or transfer < ev.until_transfer)):
                factor *= ev.factor
        return factor

    def link_jitter(self, link: int, transfer: int) -> float:
        """Seeded jitter seconds added to this transfer's wire sleep —
        a pure function of ``(seed, link, transfer)``."""
        if self.link_jitter_s <= 0:
            return 0.0
        rng = np.random.default_rng(
            np.random.SeedSequence((self.seed, link, transfer)))
        return float(rng.uniform(0.0, self.link_jitter_s))

    # -- stage faults --------------------------------------------------------
    def stage_stall_s(self, stage: int, item: int) -> float:
        """One-shot stall seconds before the stage's ``item``-th work item
        (0.0 = no stall scheduled there)."""
        return self._stalls.get((stage, item), 0.0)

    # -- replica faults ------------------------------------------------------
    @property
    def crash_step(self) -> Optional[int]:
        """Decode step after which the replica crashes (None = never)."""
        return self._crash_step
