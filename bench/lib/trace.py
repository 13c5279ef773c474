"""The profiler's view of a traced sub-window of a run.

A driver opens the trace (``TraceWindow.begin``) and closes it
(``end``) at points of its own loop.  The trace is read back from
``torch.profiler``'s Chrome export: device operations (kernels, copies,
sets), host operations, and device-to-host copies.  The busy time is the
union of the device operations' intervals (a copy of the arithmetic of
the repository's ``chip_profile.py``), so two streams running at once
count once.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


class Trace:
    """Events of one traced window: ``device`` [(name, start_us, dur_us,
    cat)], ``host`` [(name, start_us, dur_us)], and the window's length by
    the host clock."""

    def __init__(self, events: List[dict], window_s: float):
        self.window_s = window_s
        self.device = sorted(
            ((e["name"], float(e["ts"]), float(e.get("dur", 0.0)), e["cat"])
             for e in events if e.get("cat") in DEVICE_CATS),
            key=lambda e: e[1])
        self.host = sorted(
            ((e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
             for e in events if e.get("cat") in HOST_CATS
             and e.get("ph") == "X"), key=lambda e: e[1])

    def kernels(self, contains: str) -> List[Tuple[str, float, float]]:
        """Kernels whose name contains ``contains``: (name, start, dur)."""
        return [(n, t, d) for n, t, d, c in self.device
                if c == "kernel" and contains in n]

    def device_to_host_copies(self) -> int:
        return sum(1 for n, _, _, c in self.device
                   if c == "gpu_memcpy" and "DtoH" in n)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals (us)."""
        out: List[Tuple[float, float]] = []
        for _, t, d, _ in self.device:
            a, b = t, t + d
            if out and a <= out[-1][1]:
                if b > out[-1][1]:
                    out[-1] = (out[-1][0], b)
            else:
                out.append((a, b))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def device_ops(self, top: int = 10) -> List[list]:
        """The device operations with most time: [[name, seconds]]."""
        acc: Dict[str, float] = collections.defaultdict(float)
        for n, _, d, _ in self.device:
            acc[n[:160]] += d / 1e6
        return [[n, s] for n, s in sorted(acc.items(), key=lambda kv: -kv[1])
                [:top]]

    def idle_gaps(self, top: int = 10, min_us: float = 5.0) -> List[list]:
        """Idle time between device operations, summed by the innermost
        host operation running at each gap's middle: [[name, seconds]]."""
        busy = self.busy_intervals()
        starts = [t for _, t, _ in self.host]
        acc: Dict[str, float] = collections.defaultdict(float)
        for (_, a), (b, _) in zip(busy, busy[1:]):
            if b - a < min_us:
                continue
            mid = (a + b) / 2
            label = "no host operation"
            # the latest-starting host operation still running at ``mid``
            i = bisect.bisect_right(starts, mid)
            for j in range(i - 1, max(i - 4000, -1), -1):
                n, t, d = self.host[j]
                if t + d >= mid:
                    label = n
                    break
            acc[label[:160]] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(acc.items(), key=lambda kv: -kv[1])
                [:top]]


class TraceWindow:
    """Opens ``torch.profiler`` over a part of the measured window when
    tracing is on; a no-op otherwise.  ``result`` is the Trace once
    closed."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = device
        self._prof = None
        self._t0: Optional[float] = None
        self.result: Optional[Trace] = None
        self.opened = False

    def _sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self) -> None:
        """Start and stop the profiler once (its first start takes
        seconds), so that ``begin`` inside the window is quick."""
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            torch.ones(8, device=self.device).sum()
            self._sync()

    def begin(self) -> None:
        if not self.enabled or self.opened:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        self.opened = True

    def end(self) -> None:
        """Close the traced window (the trace is read by ``collect``)."""
        if self._prof is None:
            return
        self._sync()
        self._window_s = time.perf_counter() - self._t0
        self._done, self._prof = self._prof, None
        self._done.__exit__(None, None, None)

    def collect(self) -> None:
        """Read the closed window's trace into ``result``."""
        self.end()
        prof, self._done = getattr(self, "_done", None), None
        if prof is None:
            return
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.result = Trace(events, self._window_s)


def idle_share(ctx):
    """The device's idle share (%) of the traced window: one minus the
    union of its operations' intervals over the window's length by the
    host clock; None without a trace of the device."""
    tr = ctx.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
