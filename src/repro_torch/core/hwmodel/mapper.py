"""Timeloop-lite: analytical mapping search for per-layer latency/energy.

The paper uses Timeloop [12] (linear-pruned search, victory condition 100)
plus Accelergy [13].  Offline we replace them with an analytical loop-nest
model searched the same way: enumerate tile candidates (powers of two plus
full extents), keep the best latency (energy tie-break), and stop after
``VICTORY`` consecutive non-improving mappings — the same pruned-search
shape Timeloop's ``linear-pruned`` heuristic uses.

Every MAC-heavy layer is decomposed into GEMM atoms (K×C matrix applied to
P positions).  A conv is a GEMM atom with C·R·S reduction and P = output
pixels; attention score/value matmuls are weight-less atoms whose "weights"
are activations (charged as streaming traffic, not resident parameters).
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import List, Sequence, Tuple

from repro_torch.core import layers as L
from repro_torch.core.hwmodel.arch import AcceleratorArch

VICTORY = 100  # non-improving mappings before the search stops
ACC_BYTES = 4  # partial sums are accumulated at 32 bit


@dataclasses.dataclass(frozen=True)
class GemmAtom:
    """One K×C×P matmul: out[P,K] += in[P,C] @ w[C,K].

    ``weight_resident`` False means the "weights" are activations
    (attention scores etc.): they stream and are never counted as params.
    """
    k: int
    c: int
    p: int
    weight_resident: bool = True

    @property
    def macs(self) -> int:
        return self.k * self.c * self.p


@dataclasses.dataclass(frozen=True)
class LayerCost:
    latency_s: float
    energy_j: float
    dram_bytes: float
    macs: int
    compute_s: float = 0.0
    memory_s: float = 0.0
    mapping: str = ""

    def __add__(self, other: "LayerCost") -> "LayerCost":
        return LayerCost(self.latency_s + other.latency_s,
                         self.energy_j + other.energy_j,
                         self.dram_bytes + other.dram_bytes,
                         self.macs + other.macs,
                         self.compute_s + other.compute_s,
                         self.memory_s + other.memory_s, "sum")


ZERO_COST = LayerCost(0.0, 0.0, 0.0, 0)


# ---------------------------------------------------------------------------
# decomposition of LayerInfo into GEMM atoms + elementwise element counts
# ---------------------------------------------------------------------------

def decompose(layer: L.LayerInfo) -> Tuple[List[GemmAtom], int]:
    """Returns (gemm_atoms, elementwise_elems)."""
    op = layer.op
    a = layer.attrs
    if op in (L.CONV, L.DWCONV):
        cin, _, _ = layer.in_shape
        cout, ho, wo = layer.out_shape
        kk = a.get("kernel", 1)
        groups = a.get("groups", 1)
        atom = GemmAtom(k=cout // groups, c=(cin // groups) * kk * kk,
                        p=ho * wo)
        # groups run sequentially on the array: scale P
        atom = GemmAtom(atom.k, atom.c, atom.p * groups)
        return [atom], 0
    if op == L.GEMM:
        seq = layer.in_shape[0] if len(layer.in_shape) > 1 else 1
        cin = layer.in_shape[-1]
        cout = layer.out_shape[-1]
        return [GemmAtom(k=cout, c=cin, p=seq)], 0
    if op == L.MLP:
        seq, d = layer.in_shape
        d_ff = a["d_ff"]
        n = 3 if a.get("gated", True) else 2
        atoms = [GemmAtom(d_ff, d, seq)] * (n - 1) + [GemmAtom(d, d_ff, seq)]
        return atoms, seq * d_ff * (n - 1)
    if op == L.MOE:
        seq, d = layer.in_shape
        d_ff, top_k = a["d_ff"], a["top_k"]
        n_sh = a.get("n_shared", 0)
        # rows of width d_ff: the held experts' share of the choices, and
        # the shared experts' width in experts' widths
        held = a.get("held", a["n_experts"])
        sh_ff = a.get("shared_d_ff", n_sh * d_ff) if n_sh else 0
        tokens = seq * top_k * held // a["n_experts"] + seq * sh_ff // d_ff
        atoms = [GemmAtom(a["n_experts"], d, seq, weight_resident=True),  # router
                 GemmAtom(d_ff, d, tokens), GemmAtom(d_ff, d, tokens),
                 GemmAtom(d, d_ff, tokens)]
        return atoms, tokens * d_ff * 2
    if op == L.ATTENTION:
        seq, d = layer.in_shape
        h, kv, hd = a["n_heads"], a["n_kv"], a["head_dim"]
        ctx = min(seq, a.get("window") or seq)
        atoms = [GemmAtom(h * hd + 2 * kv * hd, d, seq),          # qkv proj
                 GemmAtom(ctx, hd, seq * h, weight_resident=False),  # q·k^T
                 GemmAtom(hd, ctx, seq * h, weight_resident=False),  # p·v
                 GemmAtom(d, h * hd, seq)]                         # out proj
        return atoms, seq * h * ctx  # softmax
    if op == L.MLA:
        seq, d = layer.in_shape
        h, ql, kvl = a["n_heads"], a["q_lora_rank"], a["kv_lora_rank"]
        nope, rd, vd = a["qk_nope_dim"], a["qk_rope_dim"], a["v_head_dim"]
        atoms = [GemmAtom(ql + kvl + rd, d, seq),                 # latents
                 GemmAtom(h * (nope + rd), ql, seq),               # W_uq
                 GemmAtom(h * (nope + vd), kvl, seq),              # W_uk, W_uv
                 GemmAtom(seq, nope + rd, seq * h, weight_resident=False),
                 GemmAtom(vd, seq, seq * h, weight_resident=False),
                 GemmAtom(d, h * vd, seq)]                         # out proj
        return atoms, seq * h * seq  # softmax
    if op == L.SSM:
        seq, d = layer.in_shape
        d_in, d_st = a["d_inner"], a["d_state"]
        nh = a["n_heads"]
        atoms = [GemmAtom(2 * d_in + 2 * d_st + nh, d, seq),      # in proj
                 GemmAtom(d_st, 1, seq * d_in, weight_resident=False),  # state upd
                 GemmAtom(1, d_st, seq * d_in, weight_resident=False),  # C·h
                 GemmAtom(d, d_in, seq)]                           # out proj
        return atoms, seq * d_in * 4
    if op == L.EMBED:
        # gather: no MACs, pure memory traffic
        return [], layer.fmap_out
    # elementwise / reshaping ops
    return [], max(layer.fmap_in, layer.fmap_out)


# ---------------------------------------------------------------------------
# GEMM atom mapping search
# ---------------------------------------------------------------------------

def _tile_candidates(n: int) -> List[int]:
    c = {n}
    t = 1
    while t < n:
        c.add(t)
        t *= 2
    return sorted(c)


def _util(n: int, tile: int, lanes: int) -> float:
    """Array utilization of mapping extent ``n`` in tiles of ``tile`` onto
    ``lanes`` physical lanes."""
    per_tile = min(tile, lanes) / lanes
    edge = (n % tile) or tile
    n_tiles = math.ceil(n / tile)
    return per_tile * ((n_tiles - 1) + min(edge, lanes) / min(tile, lanes)) / n_tiles


@lru_cache(maxsize=200_000)
def _map_gemm(arch_key: Tuple, k: int, c: int, p: int,
              weight_resident: bool, bytes_per_elem: float) -> Tuple:
    """Search tilings of one GEMM atom. Cached on (arch, atom) signature.

    Returns (latency_s, energy_j, dram_bytes, compute_s, memory_s, desc).
    """
    (name, n_macs, freq, glb, dram_bw, glb_bw, rows, cols,
     mac_j, reg_j, glb_j, dram_j, leak_w) = arch_key
    bpe = bytes_per_elem
    macs = k * c * p
    w_bytes = k * c * bpe
    i_bytes = p * c * bpe
    o_bytes = p * k * bpe

    best = None
    stale = 0
    for kt in _tile_candidates(k):
        if stale > VICTORY:
            break
        for pt in _tile_candidates(p):
            for ct in _tile_candidates(c):
                # GLB capacity with double buffering
                tile_bytes = (kt * ct * bpe + pt * ct * bpe
                              + kt * pt * ACC_BYTES)
                if tile_bytes > glb / 2:
                    continue
                n_k = math.ceil(k / kt)
                n_p = math.ceil(p / pt)
                n_c = math.ceil(c / ct)
                # two loop orders; pick min DRAM traffic
                dram_a = w_bytes + i_bytes * n_k + o_bytes          # K outer
                dram_b = w_bytes * n_p + i_bytes + o_bytes          # P outer
                dram = min(dram_a, dram_b)
                if n_c > 1:  # partial-sum spill traffic
                    dram += o_bytes * (n_c - 1) * 2 * (ACC_BYTES / bpe)
                # array utilization: K on cols, P on rows
                util = max(_util(k, kt, cols) * _util(p, pt, rows), 1e-6)
                compute_s = macs / (n_macs * util * freq)
                glb_traffic = dram + macs * bpe / max(min(kt, ct, pt), 1) * 2
                memory_s = max(dram / dram_bw, glb_traffic / glb_bw)
                lat = max(compute_s, memory_s)
                energy = (macs * mac_j + dram * dram_j + glb_traffic * glb_j
                          + macs * 3 * bpe * reg_j + leak_w * lat)
                cand = (lat, energy, dram, compute_s, memory_s,
                        f"kt{kt}ct{ct}pt{pt}")
                if best is None or cand[:2] < best[:2]:
                    best = cand
                    stale = 0
                else:
                    stale += 1
    if best is None:  # nothing fits: stream at minimum tile
        dram = w_bytes + i_bytes + o_bytes
        compute_s = macs / (n_macs * 0.1 * freq)
        memory_s = dram / dram_bw
        lat = max(compute_s, memory_s)
        best = (lat, macs * mac_j + dram * dram_j + leak_w * lat, dram,
                compute_s, memory_s, "stream")
    return best


def _arch_key(arch: AcceleratorArch) -> Tuple:
    e = arch.energy
    return (arch.name, arch.n_macs, arch.freq_hz, arch.glb_bytes,
            arch.dram_bw_Bps, arch.glb_bw_Bps,
            arch.pe_rows or 16, arch.pe_cols or 16,
            e.mac_j, e.reg_j_per_byte, e.glb_j_per_byte, e.dram_j_per_byte,
            e.leakage_w)


def evaluate_layer(layer: L.LayerInfo, arch: AcceleratorArch,
                   batch: int = 1) -> LayerCost:
    """Latency/energy of one layer on one accelerator (batch folded into P)."""
    atoms, elem = decompose(layer)
    key = _arch_key(arch)
    bpe = arch.bytes_per_elem
    lat = en = dram = comp = mem = 0.0
    macs = 0
    for a in atoms:
        l, e, d, cs, ms, _ = _map_gemm(key, a.k, a.c, a.p * batch,
                                       a.weight_resident, bpe)
        lat += l
        en += e
        dram += d
        comp += cs
        mem += ms
        macs += a.macs * batch
    if elem or not atoms:
        elems = (elem or max(layer.fmap_in, layer.fmap_out)) * batch
        nbytes = elems * bpe * 2
        v_lat = max(elems / (arch.vector_width * arch.freq_hz),
                    nbytes / arch.dram_bw_Bps)
        lat += v_lat
        mem += nbytes / arch.dram_bw_Bps
        en += (nbytes * arch.energy.glb_j_per_byte
               + nbytes * arch.energy.dram_j_per_byte * 0.5
               + arch.energy.leakage_w * v_lat)
        dram += nbytes * 0.5
    return LayerCost(lat, en, dram, macs, comp, mem, layer.op)


def evaluate_segment(segment: Sequence[L.LayerInfo], arch: AcceleratorArch,
                     batch: int = 1) -> LayerCost:
    """Sequential execution of a contiguous layer segment on one platform."""
    total = ZERO_COST
    for layer in segment:
        total = total + evaluate_layer(layer, arch, batch)
    return total


def layer_cost_table(schedule: Sequence[L.LayerInfo], arch: AcceleratorArch,
                     batch: int = 1) -> List[LayerCost]:
    return [evaluate_layer(l, arch, batch) for l in schedule]
