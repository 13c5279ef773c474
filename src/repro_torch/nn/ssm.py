"""Mamba2 mixer (SSD — state-space duality, arXiv:2405.21060), the JAX
package's ``repro.nn.ssm``.

Chunked SSD for prefill: the sequence is split into chunks of ``chunk``;
the intra-chunk terms are matmuls, the inter-chunk recurrence a loop over
chunk states.  Decode is the O(1) recurrent update against a carried
state.

Shapes follow the Mamba2 head convention:
  x: (B, T, H, P)   heads x headdim,  d_inner = H*P
  A: (H,)  dt: (B, T, H)  B/C: (B, T, N)  (a single group)
State: (B, H, P, N).

Differences from the reference:

* ``impl``: ``"ref"`` (the default) is the reference's ``"ref"``;
  ``"cuda"`` and ``"auto"`` take its ``"pallas"`` branch, the SSD scan
  kernel of ``kernels.ops.ssd_scan`` (``"auto"`` only on a CUDA tensor).
* The three-operand einsums of :func:`ssd_chunked` are taken as two
  pairwise products: torch contracts left to right, and the reference's
  order would build a (b, nc, c, n, h, p) temporary.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.nn.layers import rms_norm
from repro_torch.nn.module import constant, frozen, normal_init

Cache = Dict[str, torch.Tensor]


def segsum(log_a: torch.Tensor) -> torch.Tensor:
    """Stable 'segment sum': L[..., i, j] = sum_{j<k<=i} log_a[..., k].

    Returns -inf for j > i (strictly causal decay matrix).
    log_a: (..., T) -> (..., T, T).
    """
    t = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]          # sum over (j, i]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                 device=log_a.device))
    return torch.where(mask, diff, float("-inf"))


def ssd_chunked(x, dt, A, B, C, chunk: int, D: Optional[torch.Tensor] = None,
                init_state: Optional[torch.Tensor] = None):
    """SSD forward.  Returns (y, final_state).

    x: (b, T, h, p), dt: (b, T, h) (already softplus'ed), A: (h,) (negative),
    B, C: (b, T, n).
    """
    b, T, h, p = x.shape
    n = B.shape[-1]
    if T % chunk:
        raise ValueError(f"ssd_chunked: T={T} is not a multiple of the "
                         f"chunk {chunk}")
    nc = T // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)

    dA = dtc * A                                           # (b,nc,c,h) log-decay
    dA_cs = torch.cumsum(dA, dim=2)                        # within-chunk cumsum

    # 1) intra-chunk (diagonal block): Y_intra = (C B^T * L) (dt x)
    L = torch.exp(segsum(dA.transpose(2, 3)))              # (b,nc,h,c,c)
    CB = torch.einsum("bzin,bzjn->bzij", Cc, Bc)           # (b,nc,c,c)
    att = CB[:, :, None] * L                               # (b,nc,h,c,c)
    xdt = xc * dtc[..., None]                              # (b,nc,c,h,p)
    y_intra = torch.einsum("bzhij,bzjhp->bzihp", att, xdt)

    # 2) chunk states: S_z = sum_i exp(dA_cs[end]-dA_cs[i]) B_i (dt x)_i
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # (b,nc,c,h)
    S = torch.einsum("bzin,bzihp->bzhpn", Bc,
                     xdt * decay_to_end[..., None])

    # 3) inter-chunk recurrence over z: H_z = exp(sum dA_z) H_{z-1} + S_z
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])            # (b,nc,h)
    carry = (init_state if init_state is not None
             else x.new_zeros((b, h, p, n)))
    prev = []
    for z in range(nc):
        prev.append(carry)                                 # state *before* chunk
        carry = carry * chunk_decay[:, z, :, None, None] + S[:, z]
    prev_states = torch.stack(prev, dim=1)                 # (b,nc,h,p,n)

    # 4) contribution of the carried state to each position
    state_decay = torch.exp(dA_cs)                         # (b,nc,c,h)
    y_inter = (torch.einsum("bzin,bzhpn->bzihp", Cc, prev_states)
               * state_decay[..., None])

    y = (y_intra + y_inter).reshape(b, T, h, p)
    if D is not None:
        y = y + x * D[None, None, :, None]
    return y, carry


def ssd_step(state, x_t, dt_t, A, B_t, C_t, D: Optional[torch.Tensor] = None):
    """Single-token recurrence.  state: (b,h,p,n); x_t: (b,h,p);
    dt_t: (b,h); B_t, C_t: (b,n).  Returns (y_t, new_state)."""
    dA = torch.exp(dt_t * A)                               # (b,h)
    dBx = (B_t[:, None, None, :] * x_t[..., None]
           * dt_t[..., None, None])                        # (b,h,p,n)
    new_state = state * dA[..., None, None] + dBx
    # the float32 state and a bfloat16 C_t meet in float32, as jnp.einsum
    # promotes them
    y = torch.einsum("bhpn,bn->bhp", new_state,
                     C_t.to(torch.result_type(new_state, C_t)))
    if D is not None:
        y = y + x_t * D[None, :, None]
    return y, new_state


def _pad_time(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zeros appended along axis 1 (time)."""
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], pad, *t.shape[2:]))], 1)


class Mamba2Mixer(nn.Module):
    """Full Mamba2 block mixer: in_proj -> causal conv -> SSD -> gated out.

    Weights keep the reference's layouts: ``w_in`` (d, d_proj), ``conv_w``
    (conv_kernel, channels), ``w_out`` (d_inner, d)."""

    def __init__(self, d_model: int, d_state: int = 128, expand: int = 2,
                 headdim: int = 64, conv_kernel: int = 4, chunk: int = 128,
                 *, dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d = d_model
        self.n = d_state
        self.d_inner = expand * d_model
        self.p = headdim
        self.h = self.d_inner // headdim
        self.ck = conv_kernel
        self.chunk = chunk
        # in_proj emits [z (gate), x, B, C, dt]
        self.d_proj = 2 * self.d_inner + 2 * d_state + self.h
        d, h = self.d, self.h
        conv_ch = self.d_inner + 2 * self.n
        init = dict(generator=generator, device=device, dtype=dtype)
        fixed = dict(device=device, dtype=dtype)
        self.w_in = normal_init((d, self.d_proj), d ** -0.5, **init)
        self.conv_w = normal_init((self.ck, conv_ch), 0.2, **init)
        self.conv_b = constant((conv_ch,), 0.0, **fixed)
        self.A_log = frozen(torch.log(torch.linspace(1.0, 16.0, h, **fixed)))
        self.dt_bias = frozen(torch.log(torch.expm1(
            torch.linspace(1e-3, 1e-1, h, **fixed))))
        self.D = constant((h,), 1.0, **fixed)
        self.norm = constant((self.d_inner,), 1.0, **fixed)
        self.w_out = normal_init((self.d_inner, d), self.d_inner ** -0.5,
                                 **init)

    def _split(self, proj):
        di, n = self.d_inner, self.n
        z = proj[..., :di]
        xBC = proj[..., di:di + di + 2 * n]
        dt = proj[..., di + di + 2 * n:]
        return z, xBC, dt

    def _heads(self, xBC):
        """x (B, T, H, P), B and C (B, T, N) of the convolved channels."""
        b, t = xBC.shape[:2]
        di, n = self.d_inner, self.n
        return (xBC[..., :di].reshape(b, t, self.h, self.p),
                xBC[..., di:di + n], xBC[..., di + n:])

    def forward(self, u: torch.Tensor, *, cache: Optional[Cache] = None,
                impl: str = "ref"):
        """u: (B, T, d).  cache: {'conv': (B, ck-1, ch), 'ssm': (B, h, p, n),
        'pos'}.  Returns ``(y, new_cache)``, ``new_cache`` None without a
        cache."""
        if impl not in kops.IMPLS:
            raise ValueError(f"unknown impl {impl!r}; valid choices: "
                             f"{', '.join(kops.IMPLS)}")
        b, t, _ = u.shape
        proj = u @ self.w_in
        z, xBC, dt = self._split(proj)
        dt = F.softplus(dt + self.dt_bias)
        A = -torch.exp(self.A_log)

        if cache is None or t > 1:
            # the cacheless forward, or a multi-token prefill into a cache:
            # causal depthwise conv over time after the cached history
            hist = (xBC.new_zeros((b, self.ck - 1, xBC.shape[-1]))
                    if cache is None else cache["conv"].to(xBC.dtype))
            xpad = torch.cat([hist, xBC], dim=1)
            xconv = sum(self.conv_w[i] * xpad[:, i:i + t]
                        for i in range(self.ck))
            x, B, C = self._heads(F.silu(xconv + self.conv_b))
            pad_t = (-t) % self.chunk
            x, dt, B, C = (_pad_time(a, pad_t) for a in (x, dt, B, C))
            if cache is None and kops.resolve_impl(impl, x) == "cuda":
                y, final = kops.ssd_scan(x, dt, A, B, C, chunk=self.chunk,
                                         impl="cuda")
                y = y + x * self.D[None, None, :, None]
            else:
                y, final = ssd_chunked(
                    x, dt, A, B, C, self.chunk, D=self.D,
                    init_state=None if cache is None
                    else cache["ssm"].to(x.dtype))
            y = y[:, :t].reshape(b, t, self.d_inner)
            new_cache = None if cache is None else {
                "conv": xpad[:, -(self.ck - 1):], "ssm": final,
                "pos": cache["pos"] + t}
        else:
            conv_hist = torch.cat([cache["conv"].to(xBC.dtype), xBC], dim=1)
            xconv = torch.einsum("kc,bkc->bc", self.conv_w, conv_hist)
            x, B, C = self._heads(F.silu(xconv + self.conv_b)[:, None])
            y, new_ssm = ssd_step(cache["ssm"], x[:, 0], dt[:, 0], A,
                                  B[:, 0], C[:, 0], D=self.D)
            y = y.reshape(b, 1, self.d_inner)
            new_cache = {"conv": conv_hist[:, 1:], "ssm": new_ssm,
                         "pos": cache["pos"] + 1}

        y = rms_norm(y * F.silu(z), self.norm)
        return y @ self.w_out, new_cache


def init_ssm_cache(batch: int, mixer: Mamba2Mixer, dtype=torch.float32,
                   device=None) -> Cache:
    ch = mixer.d_inner + 2 * mixer.n
    return {"conv": torch.zeros((batch, mixer.ck - 1, ch), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, mixer.h, mixer.p, mixer.n),
                               dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}
