"""The device's idle share of the traced window (``bench/lib/trace.py``:
the union of kernels, copies and sets against the window's length); on
DeepSeek-V3 it shows whether the expert layers' reads of their row
counts, or the host's stage builds, open gaps between MLA's long
attention passes."""

from bench.lib.trace import idle_share as read  # noqa: F401
