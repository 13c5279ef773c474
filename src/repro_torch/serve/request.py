"""Requests, synthetic traffic, and per-request serving accounting.

A :class:`Request` is one generation job (prompt + decode budget) with an
arrival offset; :func:`poisson_traffic` draws a stream of them from
``repro_torch.data.synthetic`` token prompts with exponential
inter-arrival gaps.
:class:`RequestRecord` is what the runtime hands back — tokens plus the
latency breakdown (TTFT = first decoded token, end-to-end latency) — and
:class:`ServeReport` aggregates records into the throughput/latency summary
the benchmarks gate on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.obs.stats import latency_summary


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (T_prompt,) int32
    max_new: int = 16
    arrival_s: float = 0.0      # offset from stream start
    deadline_s: Optional[float] = None   # absolute finish-by offset; a
    # failover router sheds (finish='shed') instead of re-admitting a
    # recovered request whose deadline already passed

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)
        assert self.prompt.ndim == 1 and self.prompt.size > 0
        assert self.max_new > 0


@dataclasses.dataclass
class RequestRecord:
    """Completed (or in-flight) request bookkeeping, wall-clock seconds
    measured from the serving run's start."""
    rid: int
    prompt_len: int
    max_new: int
    submit_s: float = 0.0
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    finish: Optional[str] = None        # 'eos' | 'length' | 'lost' | 'shed'
    replica: Optional[str] = None

    @property
    def done(self) -> bool:
        """True once the request finished successfully (EOS or length)."""
        return self.done_s is not None

    @property
    def failed(self) -> bool:
        """True when the request terminated without completing: ``'lost'``
        (stranded by replica death, retry budget exhausted) or ``'shed'``
        (deadline passed before a failover re-admission)."""
        return self.finish in ("lost", "shed")

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token (None before the first token lands)."""
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.submit_s

    @property
    def latency_s(self) -> Optional[float]:
        """Submit-to-finish wall seconds (None while running)."""
        if self.done_s is None:
            return None
        return self.done_s - self.submit_s

    def n_valid_tokens(self, eos: Optional[int]) -> int:
        """Pre-EOS tokens this request contributed."""
        if eos is None:
            return len(self.tokens)
        toks = np.asarray(self.tokens, np.int32)
        hit = np.flatnonzero(toks == eos)
        return int(hit[0]) if hit.size else len(self.tokens)


def poisson_traffic(n_requests: int, rate_rps: float, vocab: int,
                    prompt_len: int = 16, max_new: int = 16,
                    seed: int = 0) -> List[Request]:
    """A Poisson request stream: exponential inter-arrival gaps at
    ``rate_rps`` requests/s, prompts drawn from the learnable
    ``SyntheticTokens`` bigram process (fixed ``prompt_len`` so the
    prefill program compiles once)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n_requests)
    arrivals = np.cumsum(gaps) - gaps[0]          # first request at t=0
    prompts = SyntheticTokens(vocab, seed=seed).batch(
        n_requests, prompt_len, seed=seed)[:, :-1]
    return [Request(rid=i, prompt=prompts[i], max_new=max_new,
                    arrival_s=float(arrivals[i]))
            for i in range(n_requests)]


@dataclasses.dataclass
class ServeReport:
    """Aggregate view over a finished serving run."""
    records: List[RequestRecord]
    wall_s: float
    eos: Optional[int] = None
    extra: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def n_done(self) -> int:
        """Requests that finished (EOS or length)."""
        return sum(1 for r in self.records if r.done)

    @property
    def n_failed(self) -> int:
        """Requests that terminated without completing (lost or shed) —
        never silent: a stranded request always leaves a failed record."""
        return sum(1 for r in self.records if r.failed)

    @property
    def total_tokens(self) -> int:
        """Generated tokens summed over all records (EOS excluded)."""
        return sum(r.n_valid_tokens(self.eos) for r in self.records)

    @property
    def tokens_per_s(self) -> float:
        """Aggregate decode throughput over the serving wall clock."""
        return self.total_tokens / self.wall_s if self.wall_s > 0 else 0.0

    def summary(self) -> Dict[str, float]:
        """Flat metrics dict: throughput, TTFT/latency percentiles, and
        the engine's Def.-4 stats when present."""
        done = [r for r in self.records if r.done]
        ttfts = [r.ttft_s for r in done if r.ttft_s is not None]
        lats = [r.latency_s for r in done]
        out = {
            "n_requests": len(self.records),
            "n_done": len(done),
            "n_failed": self.n_failed,
            "wall_s": round(self.wall_s, 4),
            "total_tokens": self.total_tokens,
            "tokens_per_s": round(self.tokens_per_s, 1),
        }
        # one percentile definition for the whole repo: nearest-rank from
        # repro_torch.obs.stats (matches the trace CLI's breakdown exactly)
        if ttfts:
            s = latency_summary(ttfts, unit=1e3)
            out["ttft_p50_ms"] = round(s["p50"], 2)
            out["ttft_p95_ms"] = round(s["p95"], 2)
        if lats:
            s = latency_summary(lats, unit=1e3)
            out["latency_p50_ms"] = round(s["p50"], 2)
            out["latency_p95_ms"] = round(s["p95"], 2)
        out.update(self.extra)
        return out
