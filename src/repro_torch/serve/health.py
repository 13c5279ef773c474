"""Measured system health: EWMA link/stage estimators, failure detection,
and hysteresis-gated divergence monitoring.

The drift driver's scripted loop re-partitions when *told* the system
changed.  This module closes the loop with measurement, using only
signals the serve runtime already produces:

* every link shuttle reports each transfer's ``(bytes, measured wall,
  modeled wall)`` — :class:`HealthMonitor` folds them into EWMA occupancy
  estimates whose ratio (measured / modeled) is a unitless **divergence**
  of the live link from the deployed :class:`SystemSpec`;
* every stage worker heartbeats each queue poll — a worker stuck inside a
  stalled stage call stops heartbeating, which :class:`FailureDetector`
  turns into a stalled-stage verdict (no false positives on a healthy but
  *idle* worker: idle workers keep polling, and so keep heartbeating);
* :class:`DivergenceMonitor` compares the estimates against the deployed
  system with **hysteresis** — an enter threshold held for ``min_breach``
  consecutive observations fires a :class:`DriftSignal`, an exit threshold
  clears the alarm, and a cool-down bounds the re-partition rate — so a
  transient congestion spike never thrashes deployments.

Everything here is host-side bookkeeping (no JAX) and deterministic under
an injected clock: tests drive ``observe(..., now=...)`` with synthetic
samples and explicit timestamps.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.explore.spec import SystemSpec
from repro_torch.obs.handle import NOOP_OBS, Obs

# divergence observations retained for the drift timeline artifact; at the
# drift driver's 50 Hz poll this holds ~20 minutes of history
_HISTORY_MAX = 65536


class Ewma:
    """Exponentially weighted moving average: ``v <- (1-a)*v + a*x``.

    ``alpha`` trades smoothing for reaction time; ``value`` is the raw
    first sample until a second arrives.  ``n`` counts samples so callers
    can gate decisions on estimator maturity."""

    def __init__(self, alpha: float = 0.25):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self._value: Optional[float] = None
        self.n = 0

    def update(self, x: float) -> float:
        """Fold one sample in; returns the updated average."""
        self._value = (float(x) if self._value is None
                       else (1.0 - self.alpha) * self._value
                       + self.alpha * float(x))
        self.n += 1
        return self._value

    @property
    def value(self) -> float:
        """Current average (0.0 before any sample)."""
        return self._value if self._value is not None else 0.0


class _LinkHealth:
    __slots__ = ("measured_s", "model_s", "bytes_total")

    def __init__(self, alpha: float):
        self.measured_s = Ewma(alpha)
        self.model_s = Ewma(alpha)
        self.bytes_total = 0


class HealthMonitor:
    """Thread-safe collector of live serve-runtime health samples.

    One monitor observes one replica: ``n_stages`` workers (heartbeats +
    per-item busy time) and ``n_links`` shuttles (per-transfer bytes,
    measured wall, modeled wall).  All accessors are cheap and lock-guarded
    so the driver, the router, and a :class:`DivergenceMonitor` can read
    while workers write."""

    def __init__(self, n_stages: int, n_links: int, *, alpha: float = 0.25):
        if n_stages <= 0 or n_links < 0:
            raise ValueError("need n_stages > 0 and n_links >= 0")
        self.n_stages = n_stages
        self.n_links = n_links
        self._lock = threading.Lock()
        self._links = [_LinkHealth(alpha) for _ in range(n_links)]
        self._stage_busy = [Ewma(alpha) for _ in range(n_stages)]
        self._heartbeat: List[Optional[float]] = [None] * n_stages

    # -- writers (called from worker threads) -------------------------------
    def heartbeat(self, stage: int, now: float) -> None:
        """Record liveness of a stage worker at monotonic time ``now``."""
        with self._lock:
            self._heartbeat[stage] = now

    def record_stage(self, stage: int, busy_s: float, now: float) -> None:
        """Record one processed work item: ``busy_s`` of stage occupancy
        (also counts as a heartbeat)."""
        with self._lock:
            self._stage_busy[stage].update(busy_s)
            self._heartbeat[stage] = now

    def record_link(self, link: int, nbytes: int, measured_s: float,
                    model_s: float) -> None:
        """Record one transfer: wire bytes, measured wall seconds (sleep +
        host overhead, i.e. what the resource actually cost), and the wall
        the deployed spec's :class:`~repro_torch.core.link.LinkModel`
        predicts."""
        with self._lock:
            lh = self._links[link]
            lh.measured_s.update(measured_s)
            lh.model_s.update(model_s)
            lh.bytes_total += int(nbytes)

    # -- readers -------------------------------------------------------------
    def link_samples(self, link: int) -> int:
        """Transfers observed on ``link`` so far."""
        with self._lock:
            return self._links[link].measured_s.n

    def link_divergence(self, link: int) -> float:
        """Measured / modeled occupancy ratio of ``link`` (1.0 = exactly
        as deployed; 8.0 = transfers take 8x the spec's prediction; 1.0
        when the link has no samples or the model predicts zero)."""
        with self._lock:
            lh = self._links[link]
            if lh.measured_s.n == 0 or lh.model_s.value <= 0:
                return 1.0
            return lh.measured_s.value / lh.model_s.value

    def link_rate_bps(self, link: int) -> float:
        """Effective live link rate estimate: EWMA bytes-per-wall-second
        over observed transfers (0.0 with no samples)."""
        with self._lock:
            lh = self._links[link]
            if lh.measured_s.n == 0 or lh.measured_s.value <= 0:
                return 0.0
            return (lh.bytes_total / lh.measured_s.n * 8.0
                    / lh.measured_s.value)

    def stage_occupancy_s(self, stage: int) -> float:
        """EWMA per-item busy seconds of ``stage`` (0.0 with no samples)."""
        with self._lock:
            return self._stage_busy[stage].value

    def last_heartbeat(self, stage: int) -> Optional[float]:
        """Monotonic time of the stage worker's last heartbeat (None
        before the worker first reported)."""
        with self._lock:
            return self._heartbeat[stage]

    def snapshot(self) -> Dict[str, object]:
        """Flat summary for reports: per-link divergence and per-stage
        occupancy (rounded for stable artifacts)."""
        return {
            "link_divergence": [round(self.link_divergence(li), 3)
                                for li in range(self.n_links)],
            "stage_occupancy_s": [round(self.stage_occupancy_s(si), 6)
                                  for si in range(self.n_stages)],
        }


class FailureDetector:
    """Missed-heartbeat failure detector over a :class:`HealthMonitor`.

    A stage worker is *stalled* when it has heartbeat at least once and
    then gone silent for longer than ``timeout_s``.  Healthy-but-idle
    workers heartbeat on every queue poll, so a clean run never trips the
    detector (tested); a worker stuck inside a stalled stage call does."""

    def __init__(self, monitor: HealthMonitor, timeout_s: float = 1.0):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.monitor = monitor
        self.timeout_s = timeout_s

    def stalled(self, now: Optional[float] = None) -> List[int]:
        """Stage indices silent for longer than ``timeout_s`` at ``now``
        (default: the live monotonic clock)."""
        t = time.monotonic() if now is None else now
        out = []
        for si in range(self.monitor.n_stages):
            hb = self.monitor.last_heartbeat(si)
            if hb is not None and t - hb > self.timeout_s:
                out.append(si)
        return out

    def healthy(self, now: Optional[float] = None) -> bool:
        """True when no stage worker is currently stalled."""
        return not self.stalled(now)


@dataclasses.dataclass(frozen=True)
class DriftSignal:
    """One fired divergence alarm: link index, the measured divergence
    ratio at fire time, and the observation timestamp."""

    link: int
    divergence: float
    at_s: float


class DivergenceMonitor:
    """Hysteresis-gated drift detector: observed system vs deployed spec.

    Each :meth:`observe` call compares every link's measured divergence
    (from a :class:`HealthMonitor`) against the deployed
    :class:`SystemSpec`'s implicit 1.0:

    * divergence >= ``enter`` for ``min_breach`` *consecutive*
      observations fires a :class:`DriftSignal` (a shorter spike never
      fires — the anti-thrash half of hysteresis);
    * once fired, the link is *in alarm* and cannot re-fire until its
      divergence falls to <= ``exit`` (the other half: a link hovering
      around the enter threshold triggers exactly once);
    * ``cooldown_s`` rate-limits fires globally, bounding how often the
      (expensive, deployment-swapping) re-partition downstream can run;
    * links with fewer than ``min_samples`` transfers are ignored —
      estimator warm-up noise cannot fire the alarm.

    :meth:`drifted_system` converts the fired state into a same-shape
    drifted ``SystemSpec`` (measured divergence as the degradation
    factor) ready for ``OnlineRepartitioner.update(..,
    trigger="measured")``; after re-deploying, :meth:`rebase` resets the
    monitor against the new deployed spec.
    """

    def __init__(self, system: SystemSpec, *, enter: float = 2.0,
                 exit: float = 1.3, min_breach: int = 3,
                 cooldown_s: float = 5.0, min_samples: int = 4,
                 obs: Optional[Obs] = None):
        if enter <= exit:
            raise ValueError(f"need enter > exit for hysteresis, got "
                             f"enter={enter} exit={exit}")
        if min_breach < 1:
            raise ValueError(f"min_breach must be >= 1, got {min_breach}")
        self.system = system
        self.enter = enter
        self.exit = exit
        self.min_breach = min_breach
        self.cooldown_s = cooldown_s
        self.min_samples = min_samples
        n_links = len(system.links)
        self._breach = [0] * n_links
        self._alarm = [False] * n_links
        self._fired_div = [1.0] * n_links
        self._last_fire_s: Optional[float] = None
        self.signals: List[DriftSignal] = []
        # every observation's (t, per-link divergence) — the
        # measured-vs-modeled series the drift timeline artifact persists
        self.history: Deque[Tuple[float, Tuple[float, ...]]] = \
            collections.deque(maxlen=_HISTORY_MAX)
        self.obs = obs if obs is not None else NOOP_OBS

    def observe(self, monitor: HealthMonitor,
                now: Optional[float] = None) -> Optional[DriftSignal]:
        """Fold one health observation in; returns the fired
        :class:`DriftSignal` when a link crosses the hysteresis gate (at
        most one per call), else None."""
        t = time.monotonic() if now is None else now
        fired = None
        n_links = len(self.system.links)
        divs = tuple(monitor.link_divergence(li) if li < monitor.n_links
                     else 1.0 for li in range(n_links))
        self.history.append((t, divs))
        for li in range(n_links):
            if li >= monitor.n_links:
                continue            # deployment uses fewer links than spec
            if monitor.link_samples(li) < self.min_samples:
                continue
            div = divs[li]
            if self._alarm[li]:
                if div <= self.exit:           # recovered: re-arm the link
                    self._alarm[li] = False
                    self._breach[li] = 0
                    self._fired_div[li] = 1.0
                continue
            if div >= self.enter:
                self._breach[li] += 1
            else:
                self._breach[li] = 0
            in_cooldown = (self._last_fire_s is not None
                           and t - self._last_fire_s < self.cooldown_s)
            if (self._breach[li] >= self.min_breach and not in_cooldown
                    and fired is None):
                self._alarm[li] = True
                self._fired_div[li] = div
                self._last_fire_s = t
                fired = DriftSignal(link=li, divergence=div, at_s=t)
                self.signals.append(fired)
                if self.obs.enabled:
                    self.obs.tracer.instant(
                        "drift_signal", cat="health", track="health/drift",
                        args={"link": li, "divergence": round(div, 3)})
                    self.obs.metrics.counter("drift_signals_fired").inc()
                    self.obs.metrics.gauge(
                        f"link{li}_divergence").set(round(div, 4))
        return fired

    @property
    def alarmed_links(self) -> List[int]:
        """Links currently in alarm (fired, not yet recovered)."""
        return [li for li, a in enumerate(self._alarm) if a]

    def drifted_system(self) -> SystemSpec:
        """The deployed spec with every alarmed link degraded by its
        measured divergence — the same-shape system snapshot a measured
        re-partition runs against (returns the deployed spec unchanged
        when nothing is in alarm)."""
        from repro_torch.explore.online import degrade_link
        system = self.system
        for li in self.alarmed_links:
            system = degrade_link(system, li, self._fired_div[li])
        return system

    def rebase(self, system: SystemSpec) -> None:
        """Reset against a newly deployed spec (after acting on a signal):
        clears alarms, breach counters, and the cool-down clock."""
        self.system = system
        n_links = len(system.links)
        self._breach = [0] * n_links
        self._alarm = [False] * n_links
        self._fired_div = [1.0] * n_links
        self._last_fire_s = None
