"""Accelergy-style per-action energy tables (§IV, [13]).

Energies are 45/28 nm-class ballparks (Horowitz ISSCC'14 scaling): an int8
MAC ≈ 0.2 pJ, int16 ≈ 0.8 pJ; SRAM reads scale with macro size; DRAM is two
orders of magnitude above on-chip access.  Absolute joules matter less than
the *ratios* — they drive the same partitioning trade-offs the paper reports.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EnergyTable:
    """Per-action energies in joules."""

    mac_j: float                 # one multiply-accumulate at native bits
    reg_j_per_byte: float        # PE-local register file / scratchpad
    glb_j_per_byte: float        # global on-chip buffer (100s of KB)
    dram_j_per_byte: float       # off-chip access
    leakage_w: float             # static power of the whole accelerator

    def scaled_mac(self, bits: int, native_bits: int) -> float:
        """MAC energy ~ quadratic in multiplier width."""
        r = bits / native_bits
        return self.mac_j * r * r


def int16_table() -> EnergyTable:
    return EnergyTable(mac_j=0.8e-12, reg_j_per_byte=0.08e-12,
                       glb_j_per_byte=1.6e-12, dram_j_per_byte=40e-12,
                       leakage_w=0.1)


def int8_table() -> EnergyTable:
    return EnergyTable(mac_j=0.2e-12, reg_j_per_byte=0.06e-12,
                       glb_j_per_byte=1.2e-12, dram_j_per_byte=40e-12,
                       leakage_w=0.02)


def bf16_tpu_table() -> EnergyTable:
    # effective per-MAC energy for a v5e-class chip at ~200 W peak board power
    return EnergyTable(mac_j=1.0e-12, reg_j_per_byte=0.05e-12,
                       glb_j_per_byte=0.8e-12, dram_j_per_byte=8e-12,
                       leakage_w=60.0)
