"""Mixture-of-Experts FFN with capacity-based scatter dispatch (the JAX
package's ``repro.nn.moe``).

DeepSeek-style fine-grained experts: ``n_shared`` always-on shared experts
plus ``n_experts`` routed experts with top-k (softmax or sigmoid gating).
Dispatch is scatter/gather (GShard capacity semantics without the
O(T·E·C) one-hot dispatch tensor):

  1. route: top-k experts per token, position-in-expert by a stable sort;
  2. scatter the tokens into a (groups, E·C, d) buffer (overflow dropped);
  3. batched expert products on (groups, E, C, d);
  4. gather back and combine with the router weights.

Aux metrics (Switch load-balance loss, router z-loss, drop fraction) are
returned for the training loop.

Two options of the port's own, for an expert layer split over devices
(expert parallelism) and for routes that drop nothing:

* ``held=(first, count)``: the layer holds the routed experts ``first ..
  first + count - 1`` (``w_gate``/``w_up``/``w_down`` of ``count``
  experts); the router keeps all ``n_experts`` outputs and every token is
  routed over all of them, but only the held experts' part of the result
  is computed: a choice of an absent expert adds nothing.  The shared
  experts run on every token.  The default holds every expert.
* ``capacity_factor=None``: the dropless route (IBM Granite 4.0-H's).  The
  top-k of the router logits and the softmax over the k chosen (the
  renormalised softmax's top-k, formed from the chosen logits alone); the
  choices that fall on held experts grouped by expert (a stable sort, so
  each expert's rows stay in token order, and one read of the held
  experts' row counts to the host), each held expert's gated product on
  exactly its rows, and the weighted rows added back.  No choice is
  dropped.  Its ``aux`` is ``{"rows": ...}``, the number of rows the
  held experts computed (a host int): no training loss reads it.
  Softmax gating only.

Differences from the reference:

* Its sharding hooks (logical-axis hints, the ``shard_map`` over the batch
  axes, the sequence-parallel grouping of a ``seq`` mesh axis) are no-ops
  on one device and are left out.
* ``lanes``: the rows of a decode batch are independent serving lanes (a
  lane cache, ``serving.engine.SlotDecoder``).  The reference ``vmap``s its
  step over batch-1 lanes, so each lane routes as its own group; with
  ``lanes`` the port routes each row as its own group too, instead of the
  one global group of a batched decode step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn.module import normal_init


def gated_ffn(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def route_positions(idx: torch.Tensor, cap: int, e: int, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """idx: (b, t, k) expert choices -> (slot (b, t·k), keep (b, t, k)).

    A token's position in its expert is its rank among the group's choices
    of that expert in (token, choice) order: a stable sort of the
    flattened choices, as the reference ranks them.  A choice past the
    capacity is dropped to the sink slot ``e * cap``."""
    b, t, _ = idx.shape
    tk = t * k
    flat = idx.reshape(b, tk)
    order = torch.argsort(flat, dim=1, stable=True)
    sorted_ids = torch.gather(flat, 1, order).contiguous()
    first = torch.searchsorted(sorted_ids, sorted_ids, side="left")
    ranks = torch.arange(tk, device=idx.device)[None, :] - first
    pos = torch.empty_like(flat).scatter_(1, order, ranks)
    pos = pos.reshape(b, t, k)
    keep = pos < cap
    slot = torch.where(keep, idx * cap + pos, e * cap)
    return slot.reshape(b, tk), keep


def dispatch(x: torch.Tensor, slot: torch.Tensor, cap: int, e: int, k: int
             ) -> torch.Tensor:
    """(x (b, t, d), slot (b, t·k)) -> x_e (b, e, cap, d): each kept
    choice's token in its slot, dropped ones in the sink row, cut off."""
    b, t, d = x.shape
    rows = torch.arange(b, device=x.device)[:, None]
    buf = x.new_zeros((b, e * cap + 1, d))
    tok = x.repeat_interleave(k, dim=1)                  # (b, t·k, d)
    buf = buf.index_put((rows, slot), tok)
    return buf[:, :-1].reshape(b, e, cap, d)


def combine(y_e: torch.Tensor, slot: torch.Tensor, wk: torch.Tensor
            ) -> torch.Tensor:
    """(y_e (b, e, cap, d), slot (b, t·k), wk (b, t, k)) -> y (b, t, d); a
    dropped choice reads the appended zero row."""
    b, e, cap, d = y_e.shape
    t, k = wk.shape[1], wk.shape[2]
    y_flat = torch.cat([y_e.reshape(b, e * cap, d), y_e.new_zeros((b, 1, d))],
                       dim=1)
    rows = torch.arange(b, device=y_e.device)[:, None]
    y_tok = y_flat[rows, slot].reshape(b, t, k, d)
    return (y_tok * wk[..., None]).sum(dim=2)


def capacity(tokens: int, k: int, e: int, capacity_factor: float) -> int:
    """Slots per expert and group: the reference's ``max(int(tg * k * cf /
    e), 4)``."""
    return max(int(tokens * k * capacity_factor / e), 4)


class MoEFFN(nn.Module):
    """Routed experts (``router`` (d, E), ``w_gate``/``w_up`` (H, d, ff),
    ``w_down`` (H, ff, d), H the experts held: ``held=(first, H)``, all E by
    default) plus ``n_shared`` shared experts fused into one gated FFN of
    width ``shared_d_ff`` (``n_shared * ff`` by default; ``sh_gate``,
    ``sh_up``, ``sh_down``); weights in the reference's (in, out) layout.
    The held experts are ``first .. first + H - 1``: every token is routed
    over all E, and a choice of an expert not held adds nothing.
    ``capacity_factor``: the capacity route (choices past an expert's
    slots dropped), or with None the dropless route: the top-k of the
    logits and the softmax over the chosen, each held expert's product on
    exactly its rows (one read of their counts to the host)."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, top_k: int,
                 n_shared: int = 0, capacity_factor: Optional[float] = 1.25,
                 router_scale: float = 1.0, sigmoid_gate: bool = False, *,
                 held: Optional[Tuple[int, int]] = None,
                 shared_d_ff: Optional[int] = None,
                 dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d, self.ff = d_model, d_ff
        self.e, self.k, self.sh = n_experts, top_k, n_shared
        self.cap_f = capacity_factor
        self.router_scale = router_scale
        self.sigmoid_gate = sigmoid_gate
        self.held = (0, n_experts) if held is None else tuple(held)
        first, count = self.held
        if not (0 <= first and 1 <= count <= n_experts - first):
            raise ValueError(f"held {held} is no share of {n_experts} "
                             f"experts")
        if capacity_factor is None and sigmoid_gate:
            raise ValueError("the dropless route gates by softmax")
        d, ff, e = d_model, d_ff, n_experts
        std = d ** -0.5
        init = dict(generator=generator, device=device, dtype=dtype)
        self.router = normal_init((d, e), std, **init)
        self.w_gate = normal_init((count, d, ff), std, **init)
        self.w_up = normal_init((count, d, ff), std, **init)
        self.w_down = normal_init((count, ff, d), ff ** -0.5, **init)
        if n_shared:
            sf = shared_d_ff or n_shared * ff
            self.sh_gate = normal_init((d, sf), std, **init)
            self.sh_up = normal_init((d, sf), std, **init)
            self.sh_down = normal_init((sf, d), sf ** -0.5, **init)

    def route(self, x: torch.Tensor):
        """Router logits (float32), scores, and the top-k weights
        (renormalised, scaled, in ``x``'s dtype) and expert indices."""
        logits = (x @ self.router).float()                     # (b, t, E)
        scores = (torch.sigmoid(logits) if self.sigmoid_gate
                  else torch.softmax(logits, dim=-1))
        wk, idx = torch.topk(scores, self.k, dim=-1)           # (b, t, k)
        wk = (wk / torch.clamp_min(wk.sum(-1, keepdim=True), 1e-9)
              * self.router_scale).to(x.dtype)
        return logits, scores, wk, idx

    def forward(self, x: torch.Tensor, lanes: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``(y, aux)`` of ``x`` (b, t, d).  A decode step (t == 1) over
        several rows routes them as one group, as the reference does,
        unless ``lanes``: then every row is its own group.  The dropless
        route (``capacity_factor`` None) routes every token alike."""
        if self.cap_f is None:
            return self._dropless(x)
        b, t, d = x.shape
        logits, scores, wk, idx = self.route(x)
        if t == 1 and b > 1 and not lanes:
            g, tg = 1, b
        else:
            g, tg = b, t
        cap = capacity(tg, self.k, self.e, self.cap_f)
        idx_g = idx.reshape(g, tg, self.k)
        slot, keep = route_positions(idx_g, cap, self.e, self.k)
        x_e = dispatch(x.reshape(g, tg, d), slot, cap, self.e, self.k)
        first, count = self.held
        if count < self.e:                  # the held experts' slots only
            x_e = x_e[:, first:first + count]

        h = torch.einsum("becd,edf->becf", x_e, self.w_gate)
        u = torch.einsum("becd,edf->becf", x_e, self.w_up)
        y_e = torch.einsum("becf,efd->becd", F.silu(h) * u, self.w_down)
        if count < self.e:                  # an absent expert adds nothing
            y_e = F.pad(y_e, (0, 0, 0, 0, first, self.e - first - count))
        y = combine(y_e, slot, wk.reshape(g, tg, self.k)).reshape(b, t, d)
        if self.sh:
            y = y + gated_ffn(x, self.sh_gate, self.sh_up, self.sh_down)

        me = scores.reshape(-1, self.e).mean(0)                 # (E,)
        # tokens per expert: exact integers in float32 (a count below 2**24),
        # summed by index_add_, which the meta device runs, unlike bincount
        flat = idx.reshape(-1)
        counts = torch.zeros(self.e, device=flat.device).index_add_(
            0, flat, torch.ones(flat.shape, device=flat.device))
        ce = counts / (b * t)                                   # tokens/expert
        aux = {"lb_loss": self.e * torch.sum(me * ce / self.k),
               "z_loss": torch.mean(torch.logsumexp(logits, -1) ** 2),
               "dropped": 1.0 - keep.float().mean()}
        return y, aux

    def _dropless(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, int]]:
        """The dropless route over the held experts (the module
        docstring); ``aux`` holds only ``rows``."""
        b, t, d = x.shape
        logits = (x @ self.router).float()                     # (b, t, E)
        top, idx = torch.topk(logits, self.k, dim=-1)          # (b, t, k)
        wk = (torch.softmax(top, dim=-1) * self.router_scale).to(x.dtype)
        flat = x.reshape(-1, d)
        first, count = self.held
        # each held choice keyed by its expert, the rest by the sink
        # ``count``; a stable sort keeps an expert's rows in token order
        local = idx.reshape(-1) - first
        key = torch.where((local >= 0) & (local < count), local, count)
        order = torch.argsort(key, stable=True)
        rows = torch.bincount(key, minlength=count + 1)[:count].tolist()
        tok = order // self.k
        w = wk.reshape(-1)[order]
        out = torch.zeros_like(flat)
        s = 0
        for e, n in enumerate(rows):
            if n:
                r = tok[s:s + n]
                y_e = gated_ffn(flat[r], self.w_gate[e], self.w_up[e],
                                self.w_down[e])
                out.index_add_(0, r, y_e * w[s:s + n, None])
            s += n
        y = out.reshape(b, t, d)
        if self.sh:
            y = y + gated_ffn(x, self.sh_gate, self.sh_up, self.sh_down)
        return y, {"rows": s}
