"""Slot-based continuous-batching scheduler (host-side, no JAX).

Fixed decode slots; requests wait in a FIFO queue, are admitted into free
slots (:meth:`SlotScheduler.admit`), decode one token per step, and are
evicted per-slot the moment they emit EOS or exhaust ``max_new`` — the
freed slot backfills from the waiting queue on the very next ``admit``.
No lockstep waves: every slot has its own request lifetime.

The scheduler owns all request bookkeeping (tokens, TTFT, latency) and is
deliberately execution-agnostic: ``SlotDecoder``, the async stage pipeline
and the serial baseline all drive the same instance, which is what makes
"byte-identical tokens across execution modes" checkable.

Invariants (tested under randomized arrival/EOS patterns):
  * no slot leak — every slot is always either free or owned by exactly
    one in-flight request, and eviction always frees it;
  * no cross-request token bleed — a token recorded against slot ``i``
    lands only in the record of the request *currently* owning ``i``;
  * immediate backfill — after ``admit()``, a slot is only free if the
    waiting queue is empty.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.handle import NOOP_OBS, Obs
from repro_torch.serve.request import Request, RequestRecord


@dataclasses.dataclass
class _SlotState:
    req: Request
    record: RequestRecord
    n_generated: int = 0

    @property
    def position(self) -> int:
        """Next token position = prompt length + tokens generated so far."""
        return self.req.prompt.shape[0] + self.n_generated


class SlotScheduler:
    """Continuous-batching slot allocator + request bookkeeper.

    ``n_slots`` fixed decode slots; :meth:`submit` queues a request,
    :meth:`admit` fills free slots FIFO, :meth:`record_token` appends one
    decoded token and evicts on EOS/length so the slot backfills next
    admit.  Execution-agnostic: the async pipeline, the serial baseline
    and the monolithic engine all drive the same instance (see module
    docstring for the tested invariants)."""

    def __init__(self, n_slots: int, eos: Optional[int] = None, *,
                 obs: Optional[Obs] = None, track: str = "sched"):
        assert n_slots > 0
        self.n_slots = n_slots
        self.eos = eos
        self._slots: List[Optional[_SlotState]] = [None] * n_slots
        self._waiting: collections.deque = collections.deque()
        self.records: Dict[int, RequestRecord] = {}
        # request-lifecycle events (submit/admit/finish instants + the
        # submitted/admitted/finished counters) land on `track`
        self.obs = obs if obs is not None else NOOP_OBS
        self.track = track

    # -- queue side ----------------------------------------------------------
    def submit(self, req: Request, now: float = 0.0) -> RequestRecord:
        """Enqueue a request (FIFO) and open its record; rejects duplicate
        request ids."""
        if req.rid in self.records:
            raise ValueError(f"duplicate request id {req.rid}")
        rec = RequestRecord(rid=req.rid, prompt_len=req.prompt.shape[0],
                            max_new=req.max_new, submit_s=now)
        self.records[req.rid] = rec
        self._waiting.append(req)
        if self.obs.enabled:
            self.obs.tracer.instant("submit", cat="sched", track=self.track,
                                    args={"rid": req.rid})
            self.obs.metrics.counter("serve_requests_submitted").inc()
        return rec

    def admit(self) -> List[Tuple[int, Request]]:
        """Move waiting requests into free slots (FIFO), immediately and
        exhaustively: afterwards a free slot implies an empty queue.
        Returns the new (slot, request) assignments — the caller prefills
        them and records their first token via :meth:`record_token`."""
        placed = []
        for i in range(self.n_slots):
            if self._slots[i] is not None or not self._waiting:
                continue
            req = self._waiting.popleft()
            self._slots[i] = _SlotState(req, self.records[req.rid])
            placed.append((i, req))
        if placed and self.obs.enabled:
            for slot, req in placed:
                self.obs.tracer.instant(
                    "admit", cat="sched", track=self.track,
                    args={"rid": req.rid, "slot": slot})
            self.obs.metrics.counter("serve_requests_admitted").inc(
                len(placed))
        return placed

    # -- decode side ---------------------------------------------------------
    def record_token(self, slot: int, token: int,
                     now: float = 0.0) -> Optional[RequestRecord]:
        """Append one decoded token to the request owning ``slot``.  Evicts
        the slot (returning the finished record) on EOS or length; returns
        None while the request keeps running."""
        st = self._slots[slot]
        if st is None:
            raise ValueError(f"token recorded for free slot {slot}")
        st.record.tokens.append(int(token))
        st.n_generated += 1
        if st.record.first_token_s is None:
            st.record.first_token_s = now
        hit_eos = self.eos is not None and int(token) == self.eos
        if hit_eos or st.n_generated >= st.req.max_new:
            st.record.finish = "eos" if hit_eos else "length"
            st.record.done_s = now
            self._slots[slot] = None
            if self.obs.enabled:
                self.obs.tracer.instant(
                    "evict", cat="sched", track=self.track,
                    args={"rid": st.req.rid, "slot": slot,
                          "finish": st.record.finish})
                self.obs.metrics.counter("serve_requests_finished").inc()
            return st.record
        return None

    # -- views ---------------------------------------------------------------
    def active_slots(self) -> List[int]:
        """Indices of slots currently owned by an in-flight request."""
        return [i for i, s in enumerate(self._slots) if s is not None]

    def free_slots(self) -> List[int]:
        """Indices of unowned slots (empty unless the queue is drained)."""
        return [i for i, s in enumerate(self._slots) if s is None]

    def slot_request(self, slot: int) -> Optional[Request]:
        """The request owning ``slot``, or None when it is free."""
        st = self._slots[slot]
        return st.req if st is not None else None

    def position(self, slot: int) -> int:
        """Next token position of the slot's request (prompt length +
        tokens generated); raises on a free slot."""
        st = self._slots[slot]
        if st is None:
            raise ValueError(f"position of free slot {slot}")
        return st.position

    def last_token(self, slot: int) -> int:
        """The token the slot's request decodes *from* next step (its most
        recently generated token)."""
        st = self._slots[slot]
        if st is None or not st.record.tokens:
            raise ValueError(f"no generated token in slot {slot}")
        return st.record.tokens[-1]

    def unfinished_requests(self) -> List[Request]:
        """In-flight then waiting requests — what a failover router must
        re-admit elsewhere if this scheduler's engine dies."""
        active = [s.req for s in self._slots if s is not None]
        return active + list(self._waiting)

    @property
    def n_waiting(self) -> int:
        """Requests queued but not yet admitted."""
        return len(self._waiting)

    @property
    def n_active(self) -> int:
        """Slots currently decoding a request."""
        return self.n_slots - len(self.free_slots())

    @property
    def outstanding(self) -> int:
        """Queued + in-flight — the router's least-outstanding load signal."""
        return self.n_waiting + self.n_active

    @property
    def idle(self) -> bool:
        """No work anywhere: nothing active, nothing waiting."""
        return self.n_active == 0 and self.n_waiting == 0

    def check_invariants(self) -> None:
        """Assert the slot/bookkeeping invariants (used by tests)."""
        owners = [s.req.rid for s in self._slots if s is not None]
        assert len(owners) == len(set(owners)), "request owns two slots"
        waiting = [r.rid for r in self._waiting]
        assert not set(owners) & set(waiting), "request both active+waiting"
        for s in self._slots:
            if s is None:
                continue
            assert s.record is self.records[s.req.rid]
            assert not s.record.done, "finished request still holds a slot"
            assert s.n_generated == len(s.record.tokens) < s.req.max_new
