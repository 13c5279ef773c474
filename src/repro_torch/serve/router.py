"""Replica router: spread a traffic stream across N partitioned pipelines,
recovering the requests of any replica that dies mid-stream.

Each replica is a
:class:`~repro_torch.serve.pipeline_async.PipelineServeEngine` running in
its own thread on its own :class:`RequestStream`.  The router
plays the traffic's arrival process (real-time, or as one burst) and sends
every request to the replica with the fewest outstanding requests
(queued + in-flight slots) at send time — classic least-outstanding load
balancing, which beats round-robin when decode lengths vary (EOS evictions
make per-request service times heavy-tailed).

**Failover.**  When a replica dies (an injected
:class:`~repro_torch.serve.faults.ReplicaCrash`, or any worker error), the
router:

1. merges the records the dead replica *completed* before death (the
   engine stashes them in ``crash_records`` on its failure path);
2. re-admits every unfinished request to the surviving replicas —
   least-outstanding again — within a bounded per-request retry budget
   (``max_retries`` failovers) and sheds requests whose ``deadline_s``
   already passed instead of wasting survivor capacity on them;
3. records anything it cannot re-admit as an explicit failed record
   (``finish='lost'`` / ``'shed'``) in the merged report — a stranded
   request is **never silent**.

Recovered requests re-run from their prompt on a survivor, so under
greedy decoding their tokens are byte-identical to a no-fault run (the
tested invariant).  Only when *every* replica is dead does
:meth:`ReplicaRouter.serve` raise instead of reporting.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.handle import NOOP_OBS, Obs
from repro_torch.serve.pipeline_async import (PipelineServeEngine,
                                              RequestStream)
from repro_torch.serve.request import Request, RequestRecord, ServeReport

# router poll period while waiting on arrivals / drain / failures
_POLL_S = 0.002


def _failed_record(req: Request, finish: str, now: float) -> RequestRecord:
    rec = RequestRecord(rid=req.rid, prompt_len=req.prompt.shape[0],
                        max_new=req.max_new, submit_s=now)
    rec.finish = finish
    return rec


class ReplicaRouter:
    """Least-outstanding load balancer over N replica serve engines, with
    crash failover (see module docstring).

    Construct with a list of :class:`PipelineServeEngine` instances (one
    thread each), then :meth:`serve` a request list; the merged
    :class:`ServeReport` aggregates every replica's records plus any
    salvaged / failed records from crashed replicas.  ``max_retries``
    bounds how many times one request may fail over before it is recorded
    as lost."""

    def __init__(self, replicas: List[PipelineServeEngine], *,
                 max_retries: int = 2, obs: Optional[Obs] = None):
        assert replicas
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.replicas = replicas
        self.max_retries = max_retries
        # routing / failover / salvage events land on the "router" track;
        # pass the same handle to the replicas for per-stage spans
        self.obs = obs if obs is not None else NOOP_OBS

    def _pick(self, sent: List[int],
              alive: Optional[List[bool]] = None) -> Optional[int]:
        """Least outstanding among live replicas; ties broken by fewest
        requests ever sent, then lowest index (deterministic for tests).
        None when no replica is alive."""
        load = [(r.outstanding, sent[i], i)
                for i, r in enumerate(self.replicas)
                if alive is None or alive[i]]
        return min(load)[2] if load else None

    def serve(self, requests: List[Request], realtime: bool = True,
              max_wall_s: float = 120.0) -> ServeReport:
        """Play ``requests`` (sorted by ``arrival_s``) into the replica
        fleet and block until every request finishes, fails over, or is
        explicitly recorded lost/shed.  ``realtime=False`` ignores arrival
        gaps and routes the whole list as a burst.  Raises only when all
        replicas are dead (or the wall budget is exhausted)."""
        n = len(self.replicas)
        streams = [RequestStream() for _ in range(n)]
        reports: List[Optional[ServeReport]] = [None] * n
        failures: List[Tuple[int, BaseException]] = []
        alive = [True] * n
        lock = threading.Lock()

        def run_replica(i):
            try:
                reports[i] = self.replicas[i].run(streams[i],
                                                  max_wall_s=max_wall_s)
            except BaseException as e:
                # engine.crash_records is complete by the time run() raises
                with lock:
                    alive[i] = False
                    failures.append((i, e))
                streams[i].close()

        threads = [threading.Thread(target=run_replica, args=(i,),
                                    name=f"router-{r.name}", daemon=True)
                   for i, r in enumerate(self.replicas)]
        for t in threads:
            t.start()

        t0 = time.perf_counter()
        now = lambda: time.perf_counter() - t0          # noqa: E731
        sent = [0] * n
        pushed: List[Dict[int, Request]] = [dict() for _ in range(n)]
        retries: Dict[int, int] = {}
        salvaged: Dict[int, RequestRecord] = {}
        failed_records: List[RequestRecord] = []
        n_recovered = 0
        n_failures_seen = 0
        first_fail_s: Optional[float] = None
        recovery_done_s: Optional[float] = None

        def route(req: Request) -> bool:
            """Push to the best live replica; False when none is left."""
            while True:
                i = self._pick(sent, alive)
                if i is None:
                    return False
                try:
                    streams[i].push(req)
                except ValueError:
                    continue        # died between pick and push: repick
                pushed[i][req.rid] = req
                sent[i] += 1
                if self.obs.enabled:
                    self.obs.tracer.instant(
                        "route", cat="router", track="router/route",
                        args={"rid": req.rid,
                              "replica": self.replicas[i].name})
                    self.obs.metrics.counter("router_requests_routed").inc()
                return True

        def recover(i: int) -> bool:
            """Fail over replica i's requests; False when nothing is left
            to fail over *to* (all replicas dead)."""
            nonlocal n_recovered
            crashed = self.replicas[i].crash_records
            mine, pushed[i] = pushed[i], {}
            obs_on = self.obs.enabled
            if obs_on:
                self.obs.tracer.instant(
                    "replica_failed", cat="router", track="router/failover",
                    args={"replica": self.replicas[i].name,
                          "unfinished": len(mine) - len(
                              set(mine) & set(crashed))})
                self.obs.metrics.counter("router_replica_failures").inc()
            for rid, rec in crashed.items():
                if rid in mine:
                    salvaged[rid] = rec     # finished before the crash
                    del mine[rid]
                    if obs_on:
                        self.obs.tracer.instant(
                            "salvage", cat="router", track="router/failover",
                            args={"rid": rid})
                        self.obs.metrics.counter(
                            "router_requests_salvaged").inc()
            for rid, req in mine.items():
                retries[rid] = retries.get(rid, 0) + 1
                if retries[rid] > self.max_retries:
                    failed_records.append(_failed_record(req, "lost", now()))
                    if obs_on:
                        self.obs.tracer.instant(
                            "lost", cat="router", track="router/failover",
                            args={"rid": rid})
                        self.obs.metrics.counter(
                            "router_requests_lost").inc()
                elif req.deadline_s is not None and now() > req.deadline_s:
                    failed_records.append(_failed_record(req, "shed", now()))
                    if obs_on:
                        self.obs.tracer.instant(
                            "shed", cat="router", track="router/failover",
                            args={"rid": rid})
                        self.obs.metrics.counter(
                            "router_requests_shed").inc()
                elif route(req):
                    n_recovered += 1
                    if obs_on:
                        self.obs.tracer.instant(
                            "failover", cat="router", track="router/failover",
                            args={"rid": rid, "retry": retries[rid]})
                        self.obs.metrics.counter(
                            "router_requests_recovered").inc()
                else:
                    return False
            return True

        ordered = sorted(requests, key=lambda r: r.arrival_s)
        qi = 0
        all_dead_err: Optional[BaseException] = None
        try:
            while True:
                # 1. play the arrival process (everything due by `now`)
                while qi < len(ordered):
                    req = ordered[qi]
                    if realtime and req.arrival_s > now():
                        break
                    if not route(req):
                        break                     # no live replica left
                    qi += 1
                # 2. fail over any newly dead replicas
                with lock:
                    new = failures[n_failures_seen:]
                n_failures_seen += len(new)
                for i, _e in new:
                    if first_fail_s is None:
                        first_fail_s = now()
                    recovery_done_s = None        # re-arm until drained
                    recover(i)
                # 3. done? every request routed to a live replica that has
                # drained and finished it (n_submitted == routed guards the
                # drain/submit race), no failure left unprocessed
                if not any(alive):
                    all_dead_err = failures[0][1]
                    break
                with lock:
                    settled = n_failures_seen == len(failures)
                if settled and qi == len(ordered):
                    drained = all(
                        not alive[i]
                        or (streams[i].pending == 0
                            and self.replicas[i].n_submitted
                            == len(pushed[i])
                            and self.replicas[i].outstanding == 0)
                        for i in range(n))
                    if drained:
                        if first_fail_s is not None:
                            recovery_done_s = now()
                        break
                if now() > max_wall_s:
                    raise TimeoutError(
                        f"router exceeded {max_wall_s}s "
                        f"({len(ordered) - qi} request(s) unrouted)")
                time.sleep(_POLL_S)
        finally:
            for s in streams:
                s.close()
            for t in threads:
                t.join(timeout=max_wall_s + 10.0)

        # a replica may have died between the drain check and close —
        # its requests all finished, so salvage without re-admission
        for i, _e in failures[n_failures_seen:]:
            crashed = self.replicas[i].crash_records
            for rid, req in pushed[i].items():
                if rid in crashed:
                    salvaged[rid] = crashed[rid]
                else:
                    failed_records.append(_failed_record(req, "lost", now()))
            pushed[i] = {}

        if all_dead_err is not None:
            raise RuntimeError(
                "replica failed during serve") from all_dead_err

        records = [rec for rep in reports if rep is not None
                   for rec in rep.records]
        records += list(salvaged.values()) + failed_records
        # belt and braces: the zero-silent-loss invariant — every routed
        # request must be accounted for in the merged report
        seen = {rec.rid for rec in records}
        for req in ordered:
            if req.rid not in seen:
                failed_records.append(_failed_record(req, "lost", now()))
                records.append(failed_records[-1])
        wall = now()
        if self.obs.enabled:
            self.obs.tracer.complete(
                "serve", cat="router", track="router/route", start=t0,
                dur=wall, args={"n_requests": len(ordered),
                                "n_failures": len(failures)})
        extra = {"n_replicas": n, "routed_per_replica": sent,
                 "requests_recovered": n_recovered,
                 "requests_salvaged": len(salvaged),
                 "n_replica_failures": len(failures)}
        if first_fail_s is not None and recovery_done_s is not None:
            extra["recovery_ms"] = round(
                (recovery_done_s - first_fail_s) * 1e3, 1)
        for i, rep in enumerate(reports):
            if rep is not None:
                extra[f"replica{i}_tokens_per_s"] = round(rep.tokens_per_s, 1)
        eos = self.replicas[0].eos
        return ServeReport(records=records, wall_s=wall, eos=eos, extra=extra)
