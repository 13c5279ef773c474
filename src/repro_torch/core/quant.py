"""Quantizer description — §IV-C.

Only the :class:`QuantSpec` dataclass lives here: the partitioner reads a
platform's bit width from it (bytes per parameter, bytes per link element,
proxy-accuracy noise).  The fake-quantization functions belong to the
accuracy-exploration part of the port.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Uniform symmetric/affine quantizer description for one platform."""

    bits: int = 8
    symmetric: bool = True
    per_channel: bool = False     # weights: quantize per output channel
    channel_axis: int = 0

    @property
    def qmin(self) -> int:
        """Smallest representable integer code."""
        return -(2 ** (self.bits - 1)) if self.symmetric else 0

    @property
    def qmax(self) -> int:
        """Largest representable integer code."""
        return 2 ** (self.bits - 1) - 1 if self.symmetric else 2 ** self.bits - 1
