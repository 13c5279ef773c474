"""Batched generation engine: prefill + decode against KV caches.

:class:`GenerationEngine` — a wave of requests is prefilled together, then
decoded in lockstep; finished sequences are masked.  Greedy or temperature
sampling.  Prefill and decode both go through the model's
``decode_step`` against the cache, as in the JAX package's
``repro.serving.engine``.  The slot API (``SlotDecoder``) waits for the
serve runtime.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch


def valid_token_count(tokens: np.ndarray, eos: Optional[int]) -> int:
    """Pre-EOS token count over a (B, T) generation: per row, tokens
    strictly before the first ``eos`` (all T when the row never stopped).
    The throughput-accounting denominator — lockstep decoding keeps
    emitting (masked) tokens for finished rows and those must not count."""
    tokens = np.asarray(tokens)
    if eos is None or tokens.size == 0:
        return int(tokens.size)
    hit = tokens == eos
    first = np.where(hit.any(axis=1), hit.argmax(axis=1), tokens.shape[1])
    return int(first.sum())


@dataclasses.dataclass
class GenResult:
    tokens: np.ndarray          # (B, T_new)
    prefill_s: float = 0.0
    decode_s: float = 0.0
    n_valid: Optional[int] = None   # pre-EOS tokens (None: all count)

    @property
    def tokens_per_s(self) -> float:
        if self.decode_s <= 0:
            return 0.0
        n = self.tokens.size if self.n_valid is None else self.n_valid
        return n / self.decode_s


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a timing boundary)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class GenerationEngine:
    """Generation with ``model`` on its device: any port LM with
    ``init_caches``, ``decode_step`` and ``device`` (``DecoderLM``,
    ``SSMLM``)."""

    def __init__(self, model, max_seq: int = 512,
                 cache_dtype=torch.float32, impl: str = "ref"):
        self.model = model
        self.max_seq = max_seq
        self.cache_dtype = cache_dtype
        self.impl = impl

    def prefill(self, prompts: np.ndarray) -> Tuple[torch.Tensor, dict]:
        """Fresh caches with ``prompts`` (B, T) appended: returns the
        last-position logits (B, vocab) and the caches."""
        caches = self.model.init_caches(prompts.shape[0], self.max_seq,
                                        self.cache_dtype)
        tokens = torch.as_tensor(np.asarray(prompts, np.int64),
                                 device=self.model.device)
        logits, caches = self.model.decode_step(caches, {"tokens": tokens},
                                                impl=self.impl)
        return logits[:, -1], caches

    def generate(self, prompts: np.ndarray, max_new: int = 16,
                 eos: Optional[int] = None,
                 temperature: float = 0.0, seed: int = 0) -> GenResult:
        """prompts: (B, T_prompt) int (no padding).  Temperature sampling
        draws from a ``torch.Generator`` seeded with ``seed``."""
        dev = self.model.device
        b = prompts.shape[0]
        gen = torch.Generator(device=dev).manual_seed(seed)

        t0 = time.perf_counter()
        cur, caches = self.prefill(prompts)
        sync(dev)
        t1 = time.perf_counter()

        out: List[np.ndarray] = []
        done = np.zeros(b, bool)
        for _ in range(max_new):
            if temperature > 0:
                probs = torch.softmax(cur.float() / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                nxt = cur.argmax(-1)
            nxt = nxt.cpu().numpy().astype(np.int32)
            if eos is not None:
                # already-done rows are masked to eos: they keep decoding in
                # lockstep but stop contributing (real) tokens
                nxt = np.where(done, eos, nxt).astype(np.int32)
                done |= nxt == eos
            out.append(nxt)
            if eos is not None and done.all():
                break
            tokens = torch.as_tensor(nxt.astype(np.int64), device=dev)[:, None]
            logits, caches = self.model.decode_step(
                caches, {"tokens": tokens}, impl=self.impl)
            cur = logits[:, -1]
        sync(dev)
        t2 = time.perf_counter()
        tokens = np.stack(out, axis=1)
        return GenResult(tokens, prefill_s=t1 - t0, decode_s=t2 - t1,
                         n_valid=valid_token_count(tokens, eos))
