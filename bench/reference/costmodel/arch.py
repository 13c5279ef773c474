"""Accelerator architecture descriptions (§V-A workloads).

Platform A in the paper is a 16-bit Eyeriss-like accelerator @200 MHz (EYR);
platform B a Simba-like accelerator @200 MHz (SMB).  We also model a TPU v5e
chip so the same explorer can partition LLMs across pods (hardware
adaptation, DESIGN.md §3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .energy import (EnergyTable, bf16_tpu_table,
                                       int8_table, int16_table)


@dataclasses.dataclass(frozen=True)
class AcceleratorArch:
    name: str
    n_macs: int                   # MAC units active per cycle
    freq_hz: float
    bits: int                     # native operand width
    glb_bytes: int                # global on-chip buffer (tiles live here)
    mem_bytes: int                # total platform memory for Def. 3 capacity
    dram_bw_Bps: float            # off-chip bandwidth
    glb_bw_Bps: float             # on-chip buffer bandwidth
    vector_width: int             # elementwise lanes (cheap ops)
    energy: EnergyTable = dataclasses.field(default_factory=int8_table)
    # PE array geometry for utilization modeling (rows map to one tensor dim,
    # cols to another; Eyeriss row-stationary style)
    pe_rows: int = 0
    pe_cols: int = 0

    @property
    def peak_macs_per_s(self) -> float:
        return self.n_macs * self.freq_hz

    @property
    def bytes_per_elem(self) -> float:
        return self.bits / 8.0

    def roofline_latency_s(self, macs: int, nbytes: float) -> float:
        """Lower bound used for mapper sanity checks."""
        return max(macs / self.peak_macs_per_s, nbytes / self.dram_bw_Bps)


# --- the paper's two platforms ----------------------------------------------

# Eyeriss(v2)-like: 24x16 = 384 PEs, one 16-bit MAC each, 192 KB GLB.
# Fast and accurate (16-bit) but power-hungrier per MAC.
EYERISS_LIKE = AcceleratorArch(
    name="EYR", n_macs=384, freq_hz=200e6, bits=16,
    glb_bytes=192 * 1024, mem_bytes=64 * 1024 * 1024,
    dram_bw_Bps=3.2e9, glb_bw_Bps=25.6e9, vector_width=16,
    energy=int16_table(), pe_rows=24, pe_cols=16)

# Simba-like (single chiplet): 16 PEs x 8 int8 MAC lanes = 128 MACs/cycle,
# 100 KB distributed SRAM. Slower but far more energy-efficient (int8).
SIMBA_LIKE = AcceleratorArch(
    name="SMB", n_macs=128, freq_hz=200e6, bits=8,
    glb_bytes=100 * 1024, mem_bytes=128 * 1024 * 1024,
    dram_bw_Bps=3.2e9, glb_bw_Bps=25.6e9, vector_width=32,
    energy=int8_table(), pe_rows=16, pe_cols=8)

# TPU v5e chip (target hardware for the multi-pod mapping):
# 197 TFLOP/s bf16 = 98.5e12 MACs/s, 819 GB/s HBM, 16 GB HBM.
TPU_V5E = AcceleratorArch(
    name="TPUv5e", n_macs=104_858, freq_hz=940e6, bits=16,
    glb_bytes=128 * 1024 * 1024, mem_bytes=16 * 1024 ** 3,
    dram_bw_Bps=819e9, glb_bw_Bps=8e12, vector_width=8 * 128,
    energy=bf16_tpu_table(), pe_rows=128, pe_cols=128)


_ARCHS: Dict[str, AcceleratorArch] = {
    "eyr": EYERISS_LIKE, "smb": SIMBA_LIKE, "tpu_v5e": TPU_V5E,
}


def get_arch(name: str) -> AcceleratorArch:
    try:
        return _ARCHS[name.lower()]
    except KeyError:
        raise KeyError(f"unknown accelerator {name!r}; have {sorted(_ARCHS)}")


def register_arch(arch: AcceleratorArch, key: Optional[str] = None) -> None:
    _ARCHS[(key or arch.name).lower()] = arch
