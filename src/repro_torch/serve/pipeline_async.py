"""Partitioned serving runtime: continuous batching over async pipeline
stages.

:class:`PipelineServeEngine` serves a live request stream over the stages
of a :class:`repro_torch.serving.pipeline.PartitionedLMRunner`:

* **Slots & waves.**  The ``n_slots`` decode slots are split into
  ``n_groups`` independent waves (default: one per stage).  Each wave is
  one batch of cache lanes (each lane with its own write position — see
  ``SlotDecoder``), stepped by one batched call of the stage program and
  admitted/evicted per-request by the
  :class:`~repro_torch.serve.scheduler.SlotScheduler`.
* **Async double buffering** (``mode='async'``).  One worker thread per
  stage and one shuttle thread per inter-stage link, connected by bounded
  queues.  Autoregressive decode has a feedback edge (step t+1 needs step
  t's sampled token), so a single wave can never overlap with itself; with
  ``n_groups >= n_stages`` waves in flight, stage k+1 computes wave A's
  step while wave B's activations cross the link into stage k — the
  steady-state step rate approaches Def. 4's ``1/max(stage, link)``.
* **Links.**  Activations crossing stage k -> k+1 are fake-quantized to
  the producer's bit width (the existing ``link_transfer_bytes`` /
  ``QuantSpec`` path) and the wire time of an emulated
  :class:`~repro_torch.core.link.LinkModel` is slept in the shuttle
  thread, so transfers genuinely overlap with compute.
* **Streams.**  On a CUDA device every stage and every link shuttle
  enqueues its work on a ``torch.cuda.Stream`` of its own.  A tensor that
  crosses to another stream is waited for (the producer's event) and
  recorded on the consumer's stream (``record_stream``), so the caching
  allocator cannot hand its block to the producer's next item while the
  consumer still reads it.  A stage's occupancy is timed by synchronizing
  its own stream in the thread that runs it; the driver thread never
  synchronizes the device.
* **Serial baseline** (``mode='serial'``).  Identical scheduler, stage
  programs and link emulation, lockstep handoff in one thread — per step
  it pays ``sum(stage + link)``.  This is the baseline the >=1.5x
  ``serve_bench`` gate compares against, and byte-identical greedy tokens
  across the two modes is a tested invariant.

Thread-side code here is *host* code on purpose: it samples tokens with
NumPy (the reference's sampler as it is, so sampled tokens compare across
packages) from logits the last stage copies to the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.link import LinkModel
from repro_torch.core.quant import QuantSpec, quantize_tensor
from repro_torch.obs.handle import NOOP_OBS, Obs
from repro_torch.obs.stats import mean_tail
from repro_torch.serve.faults import FaultPlan, FaultTrace, ReplicaCrashError
from repro_torch.serve.health import HealthMonitor
from repro_torch.serve.request import Request, RequestRecord, ServeReport
from repro_torch.serve.scheduler import SlotScheduler
from repro_torch.serving.engine import _bump_pos, write_lane
from repro_torch.serving.pipeline import (PartitionedLMRunner,
                                          def4_throughput,
                                          link_transfer_bytes)


class RequestStream:
    """Thread-safe request feed: a traffic player / router pushes, a serve
    engine drains.  ``close()`` marks end-of-stream."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: List[Request] = []
        self._closed = False

    def push(self, req: Request) -> None:
        """Append one request; raises ValueError after :meth:`close`."""
        with self._lock:
            if self._closed:
                raise ValueError("push to a closed RequestStream")
            self._pending.append(req)

    def close(self) -> None:
        """Stop accepting requests; the engine drains what remains."""
        with self._lock:
            self._closed = True

    def drain(self) -> List[Request]:
        """Take (and clear) everything pushed since the last drain."""
        with self._lock:
            out, self._pending = self._pending, []
            return out

    @property
    def pending(self) -> int:
        """Requests pushed but not yet drained by the engine."""
        with self._lock:
            return len(self._pending)

    @property
    def closed(self) -> bool:
        """True once closed *and* fully drained."""
        with self._lock:
            return self._closed and not self._pending


def stream_of(requests: List[Request]) -> RequestStream:
    """A pre-closed stream delivering ``requests`` as one burst."""
    s = RequestStream()
    for r in requests:
        s.push(r)
    s.close()
    return s


@dataclasses.dataclass
class ServeLink:
    """Emulated inter-stage link: the producer's bit width quantizes the
    activation crossing it; an optional :class:`LinkModel` prices the wire
    time (slept by the shuttle thread / the serial loop)."""
    model: Optional[LinkModel] = None
    quant: Optional[QuantSpec] = None

    def transfer(self, x):
        """-> (activation as received, wire bytes, wire seconds)."""
        nbytes = link_transfer_bytes(x.numel(), self.quant)
        if self.quant is not None:
            x = quantize_tensor(x, self.quant)
        lat = self.model.latency_s(nbytes) if self.model is not None else 0.0
        return x, nbytes, lat


@dataclasses.dataclass
class _Item:
    """One unit of pipeline work: a wave decode step or a single-lane
    prompt prefill."""
    kind: str                   # 'decode' | 'prefill'
    group: int
    lane: int = -1              # prefill only
    x: Any = None               # tokens entering stage 0, then activations
    link_s: float = 0.0         # accumulated emulated wire seconds
    ready: Any = None           # CUDA event: ``x`` is complete on the device


_STOP = object()

# idle stage workers poll their queue at this period so they keep
# heartbeating the HealthMonitor — a quiet queue must not look like a hang
_IDLE_POLL_S = 0.05


class _PrioQueue:
    """Two-priority queue: decode items overtake prefill items.
    Admission prefills ship whole-prompt activations (long transfers /
    long stage calls) and must not head-of-line-block the steady-state
    decode waves; reordering across kinds is safe because the driver never
    lets a wave's decode and its own prefill be in flight together.

    Built from deques + a semaphore rather than ``queue.PriorityQueue``:
    per-item queue cost sits on the steady-state step path, and the
    heap/Condition machinery is measurably slower than C-level semaphore
    handoff.  Depth is bounded by the driver's per-wave in-flight gating,
    so no ``maxsize`` blocking is needed.
    """

    def __init__(self):
        import collections
        self._dqs = [collections.deque(), collections.deque(),
                     collections.deque()]    # decode | prefill | stop
        self._sem = threading.Semaphore(0)
        self._lock = threading.Lock()

    def put(self, item) -> None:
        if item is _STOP:
            prio = 2                      # drain everything else first
        else:
            prio = 0 if item.kind == "decode" else 1
        with self._lock:
            self._dqs[prio].append(item)
        self._sem.release()

    def get(self, timeout: Optional[float] = None):
        """Pop the highest-priority item; with ``timeout``, returns None
        when nothing arrives in time (lets idle workers heartbeat)."""
        if not self._sem.acquire(timeout=timeout):
            return None
        with self._lock:
            for dq in self._dqs:
                if dq:
                    return dq.popleft()
        raise RuntimeError("semaphore/queue accounting out of sync")


def _on(stream):
    """Context in which work is enqueued on ``stream`` (none on the CPU)."""
    return torch.cuda.stream(stream) if stream is not None \
        else contextlib.nullcontext()


def _receive(item: _Item, stream) -> None:
    """Hand ``item.x`` to the work about to be enqueued on ``stream``: wait
    for the event its producer recorded and tell the caching allocator that
    ``stream`` uses the block, so the producer's stream cannot reuse it
    while this stream still reads it."""
    if stream is None or not torch.is_tensor(item.x):
        return
    if item.ready is not None:
        stream.wait_event(item.ready)
    item.x.record_stream(stream)


def _mark_ready(item: _Item, stream) -> None:
    """Record that ``item.x`` is complete once ``stream``'s work so far is
    done (the event the consumer waits for)."""
    if stream is not None:
        item.ready = torch.cuda.Event()
        item.ready.record(stream)


class _StageRuntime:
    """One stage's step program + per-wave cache lanes, on its own stream.

    ``decode`` runs the step over a whole wave in one call (every lane
    advances one token; idle lanes compute from a sentinel cache and are
    never sampled); ``prefill`` runs the step over a full prompt on a fresh
    batch-1 cache and splices the result into its lane of the wave.
    """

    def __init__(self, runner: PartitionedLMRunner, si: int, lanes: int,
                 n_groups: int, capacity: int, dtype=torch.float32):
        self.si = si
        self.runner = runner
        self.capacity = capacity
        self.dtype = dtype
        self.device = runner.model.device
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.weights = runner.stage_weights(si)
        self._fn = runner.stage_step_fn(si)
        with _on(self.stream):
            self.caches = [_bump_pos(runner.init_stage_caches(
                si, lanes, capacity, dtype, lanes=True))
                for _ in range(n_groups)]
        self.decode_s: List[float] = []      # per-item compute seconds
        self.prefill_s: List[float] = []

    def _fresh(self) -> Dict:
        return self.runner.init_stage_caches(self.si, 1, self.capacity,
                                             self.dtype)

    def _input(self, x):
        """Stage 0's tokens (numpy, (B, T) or a wave's (lanes, 1, 1)) as a
        device tensor (B, T); a later stage's activations as they are."""
        if self.si > 0:
            return x
        x = np.asarray(x, np.int64)
        return torch.as_tensor(x.reshape(x.shape[0], -1), device=self.device)

    def _wait(self) -> None:
        """Block this thread until the stage's stream is idle: its
        occupancy ends when its work does."""
        if self.stream is not None:
            done = torch.cuda.Event()
            done.record(self.stream)
            done.synchronize()

    def decode(self, g: int, x):
        t0 = time.perf_counter()
        out, self.caches[g] = self._fn(self.weights, self.caches[g],
                                       self._input(x))
        self._wait()
        self.decode_s.append(time.perf_counter() - t0)
        return out

    def prefill(self, g: int, lane: int, x):
        t0 = time.perf_counter()
        out, new = self._fn(self.weights, self._fresh(), self._input(x))
        write_lane(self.caches[g], lane, new)
        self._wait()
        self.prefill_s.append(time.perf_counter() - t0)
        return out

    def run_item(self, item: _Item):
        with _on(self.stream):
            _receive(item, self.stream)
            if item.kind == "decode":
                item.x = self.decode(item.group, item.x)
            else:
                item.x = self.prefill(item.group, item.lane, item.x)
            _mark_ready(item, self.stream)
        return item

    def to_host(self, item: _Item) -> None:
        """The last stage's logits as numpy, copied on this stage's stream:
        a wave's (lanes, 1, 1, vocab) and a prefill's last position (1, 1,
        vocab), the only logits the driver samples from."""
        with _on(self.stream):
            x = item.x[:, None] if item.kind == "decode" else item.x[:, -1:]
            item.x = x.cpu().numpy()

    def warmup(self, x_decode, x_prefill):
        """Run the wave step and the prefill once on scratch caches (the
        step writes its caches in place) and return their outputs."""
        with _on(self.stream):
            scratch = _bump_pos(self.runner.init_stage_caches(
                self.si, self.caches[0]["pos"].shape[1], self.capacity,
                self.dtype, lanes=True))
            x_decode, _ = self._fn(self.weights, scratch,
                                   self._input(x_decode))
            x_prefill, _ = self._fn(self.weights, self._fresh(),
                                    self._input(x_prefill))
            self._wait()
        return x_decode, x_prefill


class PipelineServeEngine:
    """Continuous-batching serve engine over partitioned LM stages (see
    module docstring).  One instance is one replica; drive it with
    :meth:`run` on a :class:`RequestStream` (directly, or via
    ``repro_torch.serve.router.ReplicaRouter``)."""

    def __init__(self, runner: PartitionedLMRunner, *, n_slots: int = 8,
                 n_groups: Optional[int] = None, eos: Optional[int] = None,
                 links: Optional[List[ServeLink]] = None,
                 capacity: int = 128, temperature: float = 0.0,
                 seed: int = 0, mode: str = "async", name: str = "replica0",
                 faults: Optional[FaultPlan] = None,
                 health: Optional[HealthMonitor] = None,
                 obs: Optional[Obs] = None):
        if mode not in ("async", "serial"):
            raise ValueError(f"mode must be 'async' or 'serial', got {mode!r}")
        self.runner = runner
        self.n_stages = runner.n_stages
        self.n_groups = n_groups or self.n_stages
        if n_slots < self.n_groups or n_slots % self.n_groups:
            raise ValueError(
                f"n_slots={n_slots} must be a positive multiple of "
                f"n_groups={self.n_groups} (each wave holds "
                f"n_slots // n_groups cache lanes)")
        self.lanes = n_slots // self.n_groups
        self.n_slots = n_slots
        self.eos = eos
        self.temperature = temperature
        self.seed = seed
        self.mode = mode
        self.name = name
        self.links = list(links) if links else [
            ServeLink() for _ in range(self.n_stages - 1)]
        assert len(self.links) == self.n_stages - 1
        self.stages = [_StageRuntime(runner, si, self.lanes, self.n_groups,
                                     capacity)
                       for si in range(self.n_stages)]
        dev = runner.model.device
        self._link_streams = [torch.cuda.Stream(dev) if dev.type == "cuda"
                              else None for _ in self.links]
        # per-link decode occupancy: measured wall (transfer + sleep, i.e.
        # what the link resource actually costs on this host) and the pure
        # modeled wire seconds, kept separately
        self.link_decode_s: List[List[float]] = [[] for _ in self.links]
        self.link_model_s: List[List[float]] = [[] for _ in self.links]
        self._sched: Optional[SlotScheduler] = None
        self.stats: Dict[str, float] = {}
        # fault injection + measured health; a shared HealthMonitor may be
        # passed in so a DivergenceMonitor / FailureDetector outside the
        # engine observes this replica live
        self.faults = faults if faults is not None else FaultPlan()
        self.fault_trace = FaultTrace()
        self.health = health if health is not None else HealthMonitor(
            self.n_stages, len(self.links))
        self._link_xfers = [0] * len(self.links)
        self._stage_items = [0] * self.n_stages
        # on a crash/failure exit, records finished before death land here
        # so the router can merge them and re-admit only the unfinished
        self.crash_records: Dict[int, RequestRecord] = {}
        # spans land on tracks under this replica's name: stage/link rows
        # from the worker threads, sched/driver/requests rows from the
        # driver; NOOP_OBS keeps every site a single attribute check
        self.obs = obs if obs is not None else NOOP_OBS

    # -- wave helpers --------------------------------------------------------
    def _slot(self, g: int, lane: int) -> int:
        return g * self.lanes + lane

    def _group_tokens(self, sched: SlotScheduler, g: int) -> np.ndarray:
        toks = np.zeros(self.lanes, np.int32)
        for lane in range(self.lanes):
            slot = self._slot(g, lane)
            if sched.slot_request(slot) is not None:
                toks[lane] = sched.last_token(slot)
        return toks

    def _group_active(self, sched: SlotScheduler, g: int) -> bool:
        return any(sched.slot_request(self._slot(g, ln)) is not None
                   for ln in range(self.lanes))

    def _sample(self, logits: np.ndarray, rid: int, step: int) -> int:
        if self.temperature <= 0:
            return int(np.argmax(logits))
        rng = np.random.default_rng(
            np.random.SeedSequence((self.seed, rid, step)))
        g = rng.gumbel(size=logits.shape)
        return int(np.argmax(logits / self.temperature + g))

    def warmup(self, prompt_len: int) -> None:
        """Run every stage program (wave decode + one prompt length) once on
        scratch caches before the serving clock starts, so TTFT measures
        serving, not first use of the device and its libraries."""
        x = np.zeros((self.lanes, 1, 1), np.int32)
        p = np.zeros((1, prompt_len), np.int32)
        for st in self.stages:
            x, p = st.warmup(x, p)

    # -- execution backends --------------------------------------------------
    def _stage_run(self, si: int, item: _Item) -> None:
        """Run one work item through stage ``si``, applying any scheduled
        stall and reporting occupancy + heartbeat to the health monitor.
        The per-stage item counter is owned by the single thread running
        this stage, so fault indices are exact."""
        k = self._stage_items[si]
        self._stage_items[si] = k + 1
        stall = self.faults.stage_stall_s(si, k)
        if stall > 0:
            self.fault_trace.record("stage_stall", si, k, stall)
            if self.obs.enabled:
                self.obs.tracer.instant(
                    "stage_stall", cat="fault",
                    track=f"{self.name}/stage{si}",
                    args={"item": k, "stall_s": stall})
                self.obs.metrics.counter("serve_faults_injected").inc()
            time.sleep(stall)
        t0 = time.perf_counter()
        self.stages[si].run_item(item)
        t1 = time.perf_counter()
        self.health.record_stage(si, t1 - t0, time.monotonic())
        if self.obs.enabled:
            # reuse the health clock reads: tracing adds no clock calls here
            self.obs.tracer.complete(
                item.kind, cat="stage", track=f"{self.name}/stage{si}",
                start=t0, end=t1, args={"group": item.group})
            self.obs.metrics.counter("serve_stage_items").inc()

    def _link_run(self, li: int, item: _Item) -> None:
        """Push one activation across link ``li``: quantize (on the link's
        stream), sleep the (possibly degraded + jittered) wire time, report
        measured vs modeled occupancy.  The transfer counter is owned by
        the single thread shuttling this link."""
        k = self._link_xfers[li]
        self._link_xfers[li] = k + 1
        t0 = time.perf_counter()
        stream = self._link_streams[li]
        with _on(stream):
            _receive(item, stream)
            x, nbytes, lat = self.links[li].transfer(item.x)
            item.x = x
            _mark_ready(item, stream)
        factor = self.faults.link_factor(li, k)
        jitter = self.faults.link_jitter(li, k)
        if factor != 1.0:
            self.fault_trace.record("link_degrade", li, k, factor)
            if self.obs.enabled:
                self.obs.tracer.instant(
                    "link_degrade", cat="fault",
                    track=f"{self.name}/link{li}",
                    args={"xfer": k, "factor": factor})
                self.obs.metrics.counter("serve_faults_injected").inc()
        if jitter > 0.0:
            self.fault_trace.record("link_jitter", li, k, jitter)
        sleep_s = lat * factor + jitter
        if sleep_s > 0:
            time.sleep(sleep_s)
        t1 = time.perf_counter()
        if item.kind == "decode":
            wall = t1 - t0
            self.link_decode_s[li].append(wall)
            self.link_model_s[li].append(lat)
            # the monitor sees measured wall vs the *deployed spec's*
            # prediction — divergence is how it learns about the fault
            self.health.record_link(li, nbytes, wall, lat)
        if self.obs.enabled:
            # modeled wire time rides along with the measured wall so a
            # trace viewer shows the divergence per transfer
            self.obs.tracer.complete(
                item.kind, cat="link", track=f"{self.name}/link{li}",
                start=t0, end=t1,
                args={"bytes": nbytes, "group": item.group,
                      "wall_ms": round((t1 - t0) * 1e3, 3),
                      "model_ms": round(lat * 1e3, 3)})
            self.obs.metrics.counter("serve_link_transfers").inc()
        item.link_s += sleep_s

    def _serial_dispatch(self, item: _Item, done: "queue.SimpleQueue"):
        for si in range(self.n_stages):
            self._stage_run(si, item)
            if si < len(self.links):
                self._link_run(si, item)
        self.stages[-1].to_host(item)
        done.put(item)

    def _start_workers(self, done: "queue.SimpleQueue"):
        """stage 0 -> link 0 -> stage 1 -> ... -> done; each arrow is a
        bounded queue, each box a thread."""
        self._qs = [_PrioQueue() for _ in range(2 * self.n_stages - 1)]
        self._errors: List[BaseException] = []
        self._threads = []

        def stage_worker(si):
            in_q = self._qs[2 * si]
            last = si == self.n_stages - 1
            out_q = done if last else self._qs[2 * si + 1]
            while True:
                item = in_q.get(timeout=_IDLE_POLL_S)
                if item is None:                   # idle poll: still alive
                    self.health.heartbeat(si, time.monotonic())
                    continue
                if item is _STOP:
                    out_q.put(_STOP)
                    return
                try:
                    # _stage_run heartbeats on completion; a worker stuck
                    # inside a stalled stage call heartbeats *nothing*,
                    # which is exactly what FailureDetector catches
                    self._stage_run(si, item)
                    if last:
                        # hand the driver host memory: the device->host copy
                        # belongs in this worker, not on the driver's
                        # critical sampling path
                        self.stages[-1].to_host(item)
                    out_q.put(item)
                except BaseException as e:          # surface in the driver
                    self._errors.append(e)
                    out_q.put(_STOP)
                    return

        def link_worker(li):
            in_q, out_q = self._qs[2 * li + 1], self._qs[2 * li + 2]
            while True:
                item = in_q.get()
                if item is _STOP:
                    out_q.put(_STOP)
                    return
                try:
                    self._link_run(li, item)
                    out_q.put(item)
                except BaseException as e:
                    self._errors.append(e)
                    out_q.put(_STOP)
                    return

        for si in range(self.n_stages):
            t = threading.Thread(target=stage_worker, args=(si,),
                                 name=f"{self.name}-stage{si}", daemon=True)
            t.start()
            self._threads.append(t)
        for li in range(len(self.links)):
            t = threading.Thread(target=link_worker, args=(li,),
                                 name=f"{self.name}-link{li}", daemon=True)
            t.start()
            self._threads.append(t)

    # -- the serve loop ------------------------------------------------------
    @property
    def outstanding(self) -> int:
        """Queued + in-flight requests (the router's load signal)."""
        sched = self._sched
        return sched.outstanding if sched is not None else 0

    @property
    def n_submitted(self) -> int:
        """Requests this run has drained into its scheduler so far (the
        router's drained-everything signal; 0 outside a run)."""
        sched = self._sched
        return len(sched.records) if sched is not None else 0

    def run(self, stream: RequestStream,
            max_wall_s: float = 120.0) -> ServeReport:
        """Serve the stream to completion (admit -> prefill -> wave decode
        until idle and the stream closes); returns the ServeReport."""
        sched = SlotScheduler(self.n_slots, eos=self.eos, obs=self.obs,
                              track=f"{self.name}/sched")
        self._sched = sched
        for st in self.stages:                   # fresh per-run accounting
            st.decode_s = []
            st.prefill_s = []
        self.link_decode_s = [[] for _ in self.links]
        self.link_model_s = [[] for _ in self.links]
        self.fault_trace = FaultTrace()          # per-run fault log
        self._link_xfers = [0] * len(self.links)
        self._stage_items = [0] * self.n_stages
        self.crash_records = {}
        crash_at = self.faults.crash_step
        done: "queue.SimpleQueue" = queue.SimpleQueue()
        if self.mode == "async":
            self._start_workers(done)
            dispatch = self._qs[0].put
        else:
            self._errors = []
            dispatch = lambda item: self._serial_dispatch(item, done)  # noqa: E731

        in_flight = [False] * self.n_groups
        pending_prefill = [0] * self.n_groups
        decode_done_t: List[float] = []
        t0 = time.perf_counter()
        now = lambda: time.perf_counter() - t0  # noqa: E731

        def admit_and_dispatch():
            # payloads stay numpy here: stage 0 does the host->device
            # transfer in its own worker thread, on its own stream
            for req in stream.drain():
                sched.submit(req, now())
            for slot, req in sched.admit():
                g, lane = divmod(slot, self.lanes)
                pending_prefill[g] += 1
                dispatch(_Item("prefill", g, lane, x=req.prompt[None]))
            for g in range(self.n_groups):
                if (not in_flight[g] and pending_prefill[g] == 0
                        and self._group_active(sched, g)):
                    in_flight[g] = True
                    toks = self._group_tokens(sched, g)
                    dispatch(_Item("decode", g,
                                   x=toks.reshape(self.lanes, 1, 1)))

        def handle(item: _Item):
            logits = item.x                        # np, converted stage-side
            if item.kind == "prefill":
                g, lane = item.group, item.lane
                pending_prefill[g] -= 1
                slot = self._slot(g, lane)
                req = sched.slot_request(slot)
                if req is not None:
                    tok = self._sample(logits[0, -1], req.rid, 0)
                    sched.record_token(slot, tok, now())
            else:
                g = item.group
                in_flight[g] = False
                decode_done_t.append(now())
                for lane in range(self.lanes):
                    slot = self._slot(g, lane)
                    req = sched.slot_request(slot)
                    if req is None:
                        continue
                    rec = sched.records[req.rid]
                    if not rec.tokens:
                        # Admitted into a free lane after this wave was
                        # dispatched (streaming arrival): these logits
                        # predate the request — its first token comes from
                        # its in-flight prefill.  Lanes genuinely in the
                        # wave always have >=1 token, because decode
                        # dispatch requires pending_prefill[g] == 0.
                        continue
                    tok = self._sample(logits[lane, 0, -1], req.rid,
                                       len(rec.tokens))
                    sched.record_token(slot, tok, now())

        try:
            while True:
                if self._errors:
                    raise RuntimeError(
                        "serve worker failed") from self._errors[0]
                if crash_at is not None and len(decode_done_t) >= crash_at:
                    self.fault_trace.record("replica_crash", 0,
                                            len(decode_done_t))
                    if self.obs.enabled:
                        # marks where this replica's tracks end in the trace
                        self.obs.tracer.instant(
                            "replica_crash", cat="fault",
                            track=f"{self.name}/driver",
                            args={"step": len(decode_done_t)})
                        self.obs.metrics.counter(
                            "serve_replica_crashes").inc()
                    raise ReplicaCrashError(self.name, len(decode_done_t))
                admit_and_dispatch()
                try:
                    item = done.get(timeout=0.002)
                except queue.Empty:
                    item = None
                got_any = False
                while item is not None:            # drain the whole burst
                    if item is not _STOP:
                        handle(item)
                        got_any = True
                    try:
                        item = done.get_nowait()
                    except queue.Empty:
                        item = None
                if got_any:
                    admit_and_dispatch()
                if (stream.closed and sched.idle and not any(in_flight)
                        and not any(pending_prefill)):
                    break
                if now() > max_wall_s:
                    raise TimeoutError(
                        f"serve run exceeded {max_wall_s}s "
                        f"({sched.outstanding} request(s) outstanding)")
            wall = now()
        except BaseException:
            # stash what *did* finish before death so a router can merge
            # these records and re-admit only the genuinely unfinished
            for rid, rec in sched.records.items():
                if rec.done:
                    rec.replica = self.name
                    self.crash_records[rid] = rec
            if self.obs.enabled:
                # finished-before-crash requests still get their spans on
                # this replica's track; the unfinished ones re-appear on
                # whichever survivor the router re-admits them to
                self._emit_request_spans(self.crash_records.values(), t0)
            raise
        finally:
            # error/timeout exits must not leak worker threads (blocked in
            # _PrioQueue.get) or leave the router seeing stale outstanding
            # load for a dead replica
            self._sched = None
            if self.mode == "async":
                self._qs[0].put(_STOP)
                for t in self._threads:
                    t.join(timeout=10.0)
        self._finalize_stats(wall, decode_done_t)
        for rec in sched.records.values():
            rec.replica = self.name
        if self.obs.enabled:
            self.obs.tracer.complete(
                "serve", cat="driver", track=f"{self.name}/driver",
                start=t0, dur=wall,
                args={"mode": self.mode,
                      "decode_steps": len(decode_done_t)})
            self._emit_request_spans(sched.records.values(), t0)
        return ServeReport(records=list(sched.records.values()),
                           wall_s=wall, eos=self.eos,
                           extra=dict(self.stats))

    def _emit_request_spans(self, records, t0: float) -> None:
        """One ``cat='request'`` span per finished record on this
        replica's ``requests`` track, rebuilt from the scheduler's
        bookkeeping (``t0``: the run's ``perf_counter`` origin).  Span
        start/duration equal the record's submit/latency exactly, so the
        ``python -m repro_torch.obs`` breakdown reconciles with
        ``ServeReport.summary()``."""
        for rec in records:
            if not rec.done:
                continue
            args = {"rid": rec.rid, "tokens": len(rec.tokens),
                    "finish": rec.finish, "prompt_len": rec.prompt_len}
            if rec.ttft_s is not None:
                args["ttft_ms"] = round(rec.ttft_s * 1e3, 3)
                self.obs.metrics.histogram("serve_ttft_ms").observe(
                    rec.ttft_s * 1e3)
            if rec.latency_s is not None:
                self.obs.metrics.histogram("serve_latency_ms").observe(
                    rec.latency_s * 1e3)
            self.obs.tracer.complete(
                f"req{rec.rid}", cat="request",
                track=f"{self.name}/requests",
                start=t0 + rec.submit_s, dur=rec.latency_s or 0.0,
                args=args)

    def _finalize_stats(self, wall: float, decode_done_t: List[float]):
        """Measured step rate vs the Def.-4 prediction from per-stage /
        per-link decode times (first ``2 * n_groups`` items dropped: first
        use when :meth:`warmup` was skipped, queue fill otherwise).

        Def. 4 takes each resource's *occupancy per item* as input; on this
        emulated deployment that is the measured wall a stage / link spends
        per wave step, so the prediction is fed measured occupancies
        (``stage_step_s`` / ``link_step_s``).  The pure modeled wire time is
        reported alongside as ``link_model_s``.
        """
        skip = 2 * self.n_groups
        stage_means = [mean_tail(st.decode_s, skip) for st in self.stages]
        link_means = [mean_tail(xs, skip) for xs in self.link_decode_s]
        link_model = [mean_tail(xs, skip) for xs in self.link_model_s]
        steps = len(decode_done_t)
        steady = decode_done_t[skip:]
        if len(steady) >= 2:
            measured = (len(steady) - 1) / (steady[-1] - steady[0])
        elif steps >= 1 and wall > 0:
            measured = steps / wall
        else:
            measured = 0.0
        self.stats = {
            "mode": self.mode,
            "decode_steps": steps,
            "stage_step_s": [round(t, 6) for t in stage_means],
            "link_step_s": [round(t, 6) for t in link_means],
            "link_model_s": [round(t, 6) for t in link_model],
            "def4_steps_per_s": round(def4_throughput(stage_means,
                                                      link_means), 2),
            "measured_steps_per_s": round(measured, 2),
            "faults_injected": len(self.fault_trace),
        }
