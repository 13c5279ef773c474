"""Batched generation engine: prefill + decode against KV caches.

Two execution modes, as in the JAX package's ``repro.serving.engine``:

Both run their forwards under ``torch.no_grad()``, so a model that was
trained (its parameters taking gradients) records no autograd graph here.

* :class:`GenerationEngine` — a wave of requests is prefilled together,
  then decoded in lockstep; finished sequences are masked.  Greedy or
  temperature sampling.  Prefill and decode both go through the model's
  ``decode_step`` against the cache.  The serial reference the
  ``repro_torch.serve`` runtime is checked against.
* :class:`SlotDecoder` — the slot API under ``repro_torch.serve``
  continuous batching: every slot is a cache lane with its own write
  position, and one decode step over all lanes is one batched call (the
  lanes are the rows of one lane cache, where the reference ``vmap``s a
  step over batch-1 caches), so per-request admission and eviction never
  share cache state across requests.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

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

    @torch.no_grad()
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

    @torch.no_grad()
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


def _bump_pos(cache):
    """Sentinel variant of a fresh cache: ``pos`` advanced past one zero
    key/value row (every lane's, with lane caches) so a never-admitted lane
    still has >= 1 visible cache entry — an all-masked attention row
    softmaxes to NaN otherwise."""
    if isinstance(cache, dict):
        return {k: (v + 1 if k == "pos" else _bump_pos(v))
                for k, v in cache.items()}
    return cache


def write_lane(lanes: Dict, lane: int, one: Dict) -> None:
    """Splice the stacked batch-1 cache ``one`` (each tensor (L, 1, S, ...),
    ``pos`` (L,)) into lane ``lane`` of the stacked lane caches ``lanes``
    (each tensor (L, B, S, ...), ``pos`` (L, B)), in place: KV caches
    (``k``, ``v``) and MLA's latent caches (``ckv``, ``kr``) alike."""
    for key, t in one.items():
        lanes[key][:, lane] = t if key == "pos" else t[:, 0]


class SlotDecoder:
    """Per-slot KV cache lanes + one batched decode step (the engine slot
    API).

    Each of the ``n_slots`` lanes has its own write position; :meth:`decode`
    advances every lane in one batched call (idle lanes compute garbage
    that is never sampled — the fixed cost of static-slot continuous
    batching), while :meth:`prefill` replaces a single lane's cache
    wholesale with a freshly prefilled one, so no token of an evicted
    request can leak into its successor.  ``model``: a ``DecoderLM`` (its
    caches take lanes; every stack's cache is written, and a MoE block
    routes each lane as its own group, as the reference's ``vmap`` over
    batch-1 lanes does).
    """

    def __init__(self, model, n_slots: int, max_seq: int,
                 cache_dtype=torch.float32):
        self.model = model
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.cache_dtype = cache_dtype
        self._idle = _bump_pos(model.init_caches(1, max_seq, cache_dtype))
        self.caches = _bump_pos(model.init_caches(n_slots, max_seq,
                                                  cache_dtype, lanes=True))

    @torch.no_grad()
    def prefill(self, slot: int, prompt: np.ndarray) -> np.ndarray:
        """Admit a prompt (T,) into ``slot``: fresh batch-1 cache,
        full-prompt prefill, cache written into the lane.  Returns the
        last-position logits."""
        fresh = self.model.init_caches(1, self.max_seq, self.cache_dtype)
        toks = torch.as_tensor(np.asarray(prompt, np.int64),
                               device=self.model.device)[None]
        logits, new = self.model.decode_step(fresh, {"tokens": toks})
        for name, one in new.items():
            write_lane(self.caches[name], slot, one)
        return logits[0, -1].cpu().numpy()

    def free(self, slot: int) -> None:
        """Reset a lane to the idle sentinel (eviction hygiene — admission
        via :meth:`prefill` overwrites the lane anyway)."""
        for name, one in self._idle.items():
            write_lane(self.caches[name], slot, one)

    @torch.no_grad()
    def decode(self, tokens: np.ndarray) -> np.ndarray:
        """One decode step for every lane. ``tokens``: (n_slots,) int —
        idle lanes get a dummy token whose logits the caller ignores.
        Returns (n_slots, vocab) logits."""
        toks = torch.as_tensor(np.asarray(tokens, np.int64),
                               device=self.model.device)[:, None]
        logits, self.caches = self.model.decode_step(self.caches,
                                                     {"tokens": toks})
        return logits[:, -1].cpu().numpy()
