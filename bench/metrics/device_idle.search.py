"""The device's idle share of the traced window (``bench/lib/trace.py``:
the union of kernels, copies and sets against the window's length)."""

from bench.lib.trace import idle_share as read  # noqa: F401
