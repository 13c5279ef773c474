"""Link models — latency and energy for shipping a cut tensor between
platforms (§IV, CNNParted-style Gigabit Ethernet model) plus TPU-era links
(PCIe, ICI, inter-pod DCI) for the multi-pod mapping.

The CNNParted GigE model charges a constant per-packet overhead on top of
wire bytes and a per-byte transceiver energy; we reproduce that shape:

  d_link(bytes)  = t_setup + ceil(bytes / payload) * (payload + header) * 8 / rate
  e_link(bytes)  = (p_tx + p_rx) * d_link + e_per_byte * bytes
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class LinkModel:
    name: str
    rate_bps: float                 # raw line rate
    t_setup_s: float = 0.0          # per-transfer setup latency
    payload_bytes: int = 1460       # MTU payload
    header_bytes: int = 58          # Ethernet+IP+TCP header + IFG equivalent
    p_tx_w: float = 0.0             # active transmit power
    p_rx_w: float = 0.0             # active receive power
    e_per_byte_j: float = 0.0       # transceiver energy per byte

    def latency_s(self, nbytes: int) -> float:
        """Transfer wall seconds for ``nbytes``: setup + packetized wire
        time including per-packet headers (paper Eq. for t_link)."""
        if nbytes <= 0:
            return 0.0
        packets = math.ceil(nbytes / self.payload_bytes)
        wire_bits = (nbytes + packets * self.header_bytes) * 8
        return self.t_setup_s + wire_bits / self.rate_bps

    def energy_j(self, nbytes: int) -> float:
        """Transfer energy: TX+RX power over the wall time plus the
        per-byte transceiver cost."""
        if nbytes <= 0:
            return 0.0
        d = self.latency_s(nbytes)
        return (self.p_tx_w + self.p_rx_w) * d + self.e_per_byte_j * nbytes

    def latency_s_vec(self, nbytes: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`latency_s` over an array of transfer sizes."""
        nb = np.asarray(nbytes, dtype=np.float64)
        packets = np.ceil(nb / self.payload_bytes)
        wire_bits = (nb + packets * self.header_bytes) * 8
        return np.where(nb > 0, self.t_setup_s + wire_bits / self.rate_bps,
                        0.0)

    def energy_j_vec(self, nbytes: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`energy_j` over an array of transfer sizes."""
        nb = np.asarray(nbytes, dtype=np.float64)
        d = self.latency_s_vec(nb)
        return np.where(nb > 0,
                        (self.p_tx_w + self.p_rx_w) * d
                        + self.e_per_byte_j * nb, 0.0)

    def effective_bw(self, nbytes: int) -> float:
        """bytes/s actually achieved for a transfer of this size."""
        d = self.latency_s(nbytes)
        return nbytes / d if d > 0 else float("inf")


# -- canonical links ---------------------------------------------------------

def gigabit_ethernet() -> LinkModel:
    """CNNParted-style GigE: 1 Gbit/s, TCP framing, ~100 µs setup,
    ~1.2 W tx / 1.0 W rx NIC power, 5 nJ/byte PHY energy."""
    return LinkModel("gige", rate_bps=1e9, t_setup_s=100e-6,
                     payload_bytes=1460, header_bytes=58,
                     p_tx_w=1.2, p_rx_w=1.0, e_per_byte_j=5e-9)


def pcie_gen4_x4() -> LinkModel:
    return LinkModel("pcie4x4", rate_bps=64e9, t_setup_s=2e-6,
                     payload_bytes=4096, header_bytes=24,
                     p_tx_w=2.0, p_rx_w=2.0, e_per_byte_j=1e-9)


def tpu_ici() -> LinkModel:
    """Single v5e ICI link ~50 GB/s, negligible setup, ~1 pJ/bit."""
    return LinkModel("ici", rate_bps=50e9 * 8, t_setup_s=1e-6,
                     payload_bytes=1 << 20, header_bytes=0,
                     e_per_byte_j=8e-12)


def inter_pod_dci() -> LinkModel:
    """Inter-pod data-center interconnect: ~6.25 GB/s effective per pod pair
    (conservative), higher setup cost than ICI."""
    return LinkModel("dci", rate_bps=6.25e9 * 8, t_setup_s=10e-6,
                     payload_bytes=1 << 20, header_bytes=0,
                     e_per_byte_j=30e-12)


def embedded_ethernet_10() -> LinkModel:
    """10BASE-T-class industrial/embedded Ethernet: 10 Mbit/s, ~300 µs
    stack setup, small MTU — the low end of the distributed-embedded links
    the partitioner targets."""
    return LinkModel("eth10", rate_bps=10e6, t_setup_s=300e-6,
                     payload_bytes=1460, header_bytes=58,
                     p_tx_w=0.3, p_rx_w=0.25, e_per_byte_j=20e-9)


def can_fd() -> LinkModel:
    """CAN-FD automotive bus: 5 Mbit/s data phase, 64-byte frames with
    ~8 bytes framing overhead, ~200 µs arbitration/setup per transfer."""
    return LinkModel("canfd", rate_bps=5e6, t_setup_s=200e-6,
                     payload_bytes=64, header_bytes=8,
                     p_tx_w=0.1, p_rx_w=0.1, e_per_byte_j=50e-9)


LINKS = {
    "gige": gigabit_ethernet,
    "pcie4x4": pcie_gen4_x4,
    "ici": tpu_ici,
    "dci": inter_pod_dci,
    "eth10": embedded_ethernet_10,
    "canfd": can_fd,
}


def get_link(name: str) -> LinkModel:
    """Registry lookup: a fresh LinkModel by name ('gige', 'eth10', ...)."""
    try:
        return LINKS[name]()
    except KeyError:
        raise KeyError(f"unknown link {name!r}; available: {sorted(LINKS)}")
